"""Operations and bytes of the cells' work, from the configuration's shapes.

Frozen copies of the laws the JAX package's benchmark gave
(``_bench_seqrec``: attention projections, scores and values, the FFN
and the vocabulary logits, two FLOPs a multiply-add, three times the
forward for a training step, embedding gathers left out), written over
the real positions of each row, so that work the program spends on
padding counts for nothing.

A row of ``l`` real positions through the sequence model's trunk of
``layers`` blocks at width ``d`` and FFN width ``ffn``:
``l·layers·(8d² + 4d·ffn) + layers·4l²d`` (the four projections, the
two FFN matrices, the scores and the values over the row's ``l`` keys),
and ``2·d·vocab`` for each position whose logits are taken.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

#: bytes of a float32 or int32 element
F32 = 4


def seqrec_trunk_flops(length, d: int, layers: int, ffn: int):
    """The trunk's FLOPs over a row of ``length`` real positions (an int,
    or a numpy array of lengths, one value each)."""
    return (length * layers * (8 * d * d + 4 * d * ffn)
            + layers * 4 * length * length * d)


def seqrec_train_step_flops(lengths: Iterable[int], d: int, layers: int,
                            ffn: int, vocab: int) -> int:
    """A training step over rows of the given real lengths: the logits
    at every real position, three times the forward."""
    n = np.asarray(list(lengths) if not isinstance(lengths, np.ndarray)
                   else lengths, dtype=np.int64)
    return int(3 * (seqrec_trunk_flops(n, d, layers, ffn)
                    + 2 * d * vocab * n).sum())


def adam_step_bytes(n_params: int) -> int:
    """Parameters and both moments read once and written once (float32):
    what a dense Adam step over every leaf has to move."""
    return 6 * F32 * n_params


def least_seconds(flops: float, nbytes: float,
                  peak: Optional[dict]) -> Optional[float]:
    """The least time the device could take for the work: the larger of
    its operations over the float32 peak and its bytes over the memory
    bandwidth. None where the device has no entry in the table of peaks."""
    if peak is None:
        return None
    return max(flops / peak["f32_flops"], nbytes / peak["hbm_bytes_per_s"])
