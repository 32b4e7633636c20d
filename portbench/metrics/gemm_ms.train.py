"""Device ms a training step of cuBLAS matrix products."""


def read(obs):
    t = obs.get("trace") or {}
    if not t.get("seen") or not obs.get("steps") or "gemm" not in t["by_cat"]:
        return None
    return 1e3 * t["by_cat"]["gemm"]["s"] / obs["steps"]
