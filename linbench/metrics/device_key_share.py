"""``device_key_share``: of every key the window checked, the share
decided by a device engine (the batch's grid or a single-key search)."""


def read(ctx):
    engines = [e for c in ctx["checks"] for e in c["engines"].values()]
    if not engines:
        return None
    return sum(1 for e in engines if ctx["is_device_engine"](e)) / len(engines)
