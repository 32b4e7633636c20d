"""The three flash kernels' least time (the frozen ``flash_work`` at the
cell's shapes, times their launches) over their summed device time, %."""

from portbench import work


def read(obs):
    t = obs.get("trace") or {}
    m, mix = obs["model"], obs["mix"]
    if not t.get("seen") or m["family"] != "dense":
        return None
    w = work.flash_work(mix["batch"], m["n_heads"], m["n_kv_heads"],
                        mix["seq_len"], mix["seq_len"], m["head_dim"], True,
                        None, m["dtype"])
    bound = spent = 0.0
    for k in ("fwd", "dkv", "dq"):
        c = t["by_cat"].get(f"flash.{k}")
        if c:
            bound += c["n"] * work.bound_s(*w[k], m["dtype"])
            spent += c["s"]
    return 100.0 * bound / spent if spent > 0 else None
