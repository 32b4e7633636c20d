"""Share of the traced window in which no operation ran on the card, %."""


def read(obs):
    t = obs.get("trace") or {}
    if not t.get("seen") or not obs.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / obs["window_s"])
