"""entry_ms.decode: the mean host time inside the decoder's own
`scl.decode` spans (polar_tpu_torch/ops/cuda_scl.py SclDecoder) of the
traced window, per batch, in milliseconds: the inside of submit_ms.decode
(moving decode_cw_per_s). None where the program has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "decode", "scl.decode")
