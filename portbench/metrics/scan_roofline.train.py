"""The selective scan's forward and backward kernels' least time (the
frozen ``scan_work`` at the cell's shapes, times their launches) over
their summed device time, the backward's reductions included, %."""

from portbench import work


def read(obs):
    t = obs.get("trace") or {}
    m, mix = obs["model"], obs["mix"]
    if not t.get("seen") or m["family"] != "mamba":
        return None
    case = (mix["batch"], mix["seq_len"], m["d_inner"], m["ssm_state"])
    cats = t["by_cat"]
    bound = spent = 0.0
    for k in ("fwd", "bwd"):
        c = cats.get(f"ssm_scan.{k}")
        if c:
            bound += c["n"] * work.bound_s(*work.scan_work(k, case, m["dtype"]),
                                           m["dtype"])
            spent += c["s"]
    if "ssm_scan.bwd_reduce" in cats:
        spent += cats["ssm_scan.bwd_reduce"]["s"]
    return 100.0 * bound / spent if spent > 0 else None
