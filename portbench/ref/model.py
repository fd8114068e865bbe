"""The reference side of a cell: the code its configuration file states,
the frame draw, the decoder and the error count, in plain PyTorch."""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from portbench.ref.draw import count_errors, mc_draw
from portbench.ref.philox import step_seed
from portbench.ref.polar import CodeSpec, CrcSpec
from portbench.ref.scl import build_plain_scl_decoder

ROOT = pathlib.Path(__file__).resolve().parents[2]


def code_spec(config: dict) -> CodeSpec:
    """The code of a configuration file: its N, K, kernels, CRC and the
    frozen set it names (1 = frozen)."""
    code = config["code"]
    mask = np.load(ROOT / code["frozen_set"])
    if int(mask.size - mask.sum()) != code["unfrozen"]:
        raise ValueError(f"{code['frozen_set']} does not leave "
                         f"{code['unfrozen']} rows unfrozen")
    crc = CrcSpec(**code["crc"]) if code.get("crc") else None
    return CodeSpec(N=code["N"], K=code["K"], factors=tuple(code["factors"]),
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)


class Reference:
    """draw(key, sigma, batch) -> (u_true, llr); decode(llr) ->
    DecodeResult; count(u, u_true) -> [2, B] frame and bit errors. All on
    `device`, the decoder in `llr_dtype` (float32: the reference;
    bfloat16: the lower-precision control)."""

    def __init__(self, config: dict, device, llr_dtype=torch.float32):
        self.spec = code_spec(config)
        self.list_size = int(config["list_size"])
        self.device = torch.device(device)
        self.decode = build_plain_scl_decoder(self.spec, self.list_size,
                                              llr_dtype=llr_dtype)

    def draw(self, key, sigma: float, batch: int):
        return mc_draw(self.spec, key, sigma, batch, self.device)

    def count(self, u: torch.Tensor, u_true: torch.Tensor) -> torch.Tensor:
        return count_errors(self.spec, u, u_true)

    @staticmethod
    def key(seed: int, snr_index: int, step: int, rank: int = 0):
        return step_seed(seed, snr_index, step, 0, rank)
