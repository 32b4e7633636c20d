"""Median host ms of the window's server ticks that admitted no request
and decoded at least one row."""

from portbench.stats import percentile


def read(obs):
    xs = [1e3 * t["s"] for t in obs.get("ticks", [])
          if not t["admitted"] and t["live"]]
    return percentile(xs, 50) if xs else None
