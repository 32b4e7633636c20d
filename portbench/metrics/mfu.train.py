"""Model flops of the traced window's training steps (the benchmark's
formula, ``work.train_step_flops``) over the window times the card's
bf16 peak, %."""

from portbench import work


def read(obs):
    if not obs.get("window_s") or not obs.get("steps"):
        return None
    return 100.0 * obs["flops"] / (obs["window_s"] * work.PEAK_FLOPS["bfloat16"])
