"""Device ms a training step of every kernel that is neither cuBLAS nor
the port's own (AdamW, casts, norms, the loss, element-wise glue)."""


def read(obs):
    t = obs.get("trace") or {}
    if not t.get("seen") or not obs.get("steps"):
        return None
    skip = set(t["own"]) | {"gemm", "copy"}
    s = sum(v["s"] for k, v in t["by_cat"].items() if k not in skip)
    return 1e3 * s / obs["steps"]
