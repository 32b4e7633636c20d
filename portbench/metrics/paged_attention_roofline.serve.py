"""Paged attention's least time (the frozen ``paged_attention_work`` at
each traced decode step's live lengths, once a layer) over its device
time, %."""

from portbench import work


def read(obs):
    t = obs.get("trace") or {}
    c = (t.get("by_cat") or {}).get("paged_attention")
    m = obs["model"]
    if not t.get("seen") or not c or not c["s"]:
        return None
    bound = 0.0
    for lengths in obs["paged_lengths"]:
        nbytes, flops = work.paged_attention_work(
            lengths, m["n_heads"], m["n_kv_heads"], m["head_dim"],
            obs["page_tokens"], m["dtype"])
        bound += m["layers"] * work.bound_s(nbytes, flops, m["dtype"])
    return 100.0 * bound / c["s"]
