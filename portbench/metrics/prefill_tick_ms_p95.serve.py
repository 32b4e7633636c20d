"""95th percentile of the host ms of the window's server ticks that
admitted at least one request (its prefill inside), each ending in the
host's read of the step's logits."""

from portbench.stats import percentile


def read(obs):
    xs = [1e3 * t["s"] for t in obs.get("ticks", []) if t["admitted"]]
    return percentile(xs, 95) if xs else None
