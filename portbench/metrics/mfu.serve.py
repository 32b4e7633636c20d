"""Model flops of the prompt and generated tokens the traced window
processed (``work.prefill_flops`` and ``work.decode_flops``) over the
window times the card's bf16 peak, %."""

from portbench import work


def read(obs):
    if not obs.get("window_s") or not obs.get("flops"):
        return None
    return 100.0 * obs["flops"] / (obs["window_s"] * work.PEAK_FLOPS["bfloat16"])
