"""``torch.cuda.max_memory_allocated`` over the window, GiB."""


def read(obs):
    if obs.get("peak_bytes") is None:
        return None
    return obs["peak_bytes"] / 2 ** 30
