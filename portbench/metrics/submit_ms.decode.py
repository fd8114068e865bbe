"""submit_ms.decode: the mean host time, in the traced run, for the
decoder call to return, per batch, by the host clock around the call."""


def read(ctx):
    if ctx["kind"] != "decode" or ctx.get("submit_ms") is None:
        return None
    return ctx["submit_ms"]
