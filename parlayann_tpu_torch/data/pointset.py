"""PointSet — the device-resident vector store.

Counterpart of parlayann_tpu/data/pointset.py: one padded ``(n_pad, d)``
tensor per precision tier, with the metric and the scalar-quantization
parameters as metadata. Rows are padded to a multiple of ``row_pad``; pad
rows are zero and never valid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data import io
from parlayann_tpu_torch.utils.device import resolve


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PointSet:
    """A set of n d-dimensional vectors on ``data.device``.

    ``data`` is ``(n_pad, d)`` in the storage dtype (float32, uint8 or
    int8). ``bits`` is the quantization tier: 32 (full precision), 1 to 16
    (scalar-quantized: int8 up to 8 bits, int16 above; ops/quantize.py),
    or the packed 1-bit, MIPS 2-bit and 4-bit tiers. ``quant_slope`` and
    ``quant_offset`` are 0-d float32 tensors on the same device for the
    scalar tiers. The 1-bit tier's ``data`` is ``(n_pad, W)`` int32 words,
    W = ceil(d / 32), bit j of word w holding coordinate 32 w + j (the JAX
    package's uint32 words with the same bits); its ``quant_offset`` is the
    ``(d,)`` float32 threshold vector and ``quant_slope`` is None.
    """

    data: torch.Tensor
    n: int
    d: int
    metric: Metric
    bits: int = 32
    quant_slope: Optional[torch.Tensor] = None
    quant_offset: Optional[torch.Tensor] = None

    @property
    def n_pad(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to_numpy(self) -> np.ndarray:
        """The n valid rows, in the storage dtype, on the host."""
        return self.data[: self.n].cpu().numpy()

    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        metric: Metric = Metric.L2,
        normalize: bool = False,
        row_pad: int = 8,
        device=None,
    ) -> "PointSet":
        """``device=None`` is the card (utils/device.py:resolve)."""
        device = resolve(device)
        arr = np.asarray(arr)
        metric = Metric.coerce(metric)
        n, d = arr.shape
        if normalize:
            # mips auto-normalization (builder.cpp:45-54)
            arr = arr.astype(np.float32)
            norms = np.linalg.norm(arr, axis=1, keepdims=True)
            arr = arr / np.maximum(norms, 1e-30)
        n_p = pad_to(max(n, 1), row_pad)
        if n_p != n:
            arr = np.concatenate([arr, np.zeros((n_p - n, d), dtype=arr.dtype)])
        data = torch.tensor(arr, device=device)
        return PointSet(data=data, n=n, d=d, metric=metric)

    @staticmethod
    def from_file(path: str, dtype=None, metric: Metric = Metric.L2,
                  normalize: bool = False, device=None) -> "PointSet":
        """Read a ``.bin``/``.fbin``/``.u8bin``/``.i8bin``, ``.fvecs``/
        ``.bvecs``/``.ivecs`` or HDF5 file (data/io.py) onto ``device``
        (None: the card). ``dtype`` overrides the ``.bin`` element type
        inferred from the extension and the file size."""
        if path.endswith((".fvecs", ".bvecs", ".ivecs")):
            arr = io.read_vecs(path)
        elif path.endswith((".h5", ".hdf5")):
            arr = io.read_hdf5(path)
        else:
            dt = dtype if dtype is not None else io.infer_bin_dtype(path)
            arr = io.read_bin(path, dtype=dt)
        return PointSet.from_numpy(arr, metric=metric, normalize=normalize,
                                   device=device)
