"""The benchmark's plain reference: code construction, Philox, the frame
draw, CRC, encode and the SC/SCL decoder in plain PyTorch and NumPy.

Frozen copies of polar_tpu_torch's plain versions as they stood when the
benchmark was written, with their imports pointed into this package. They
import nothing of the program, so a later change to the program cannot
move the yardstick it is held to.
"""
