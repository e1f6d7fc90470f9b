"""The eval summary's running average.

Port of mhentropy_tpu/utils/logging.py's `AverageMeter` (:23-49), the
reference's meter (utils.py:75-91) with its quirk of dropping zero-valued
updates, on by default for log parity. The port keeps its own copy so that
it imports nothing of the JAX package. `get_logger` and `ScalarWriter` are
not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations


class AverageMeter:
    """Running average.

    The reference's update() counts a sample only when val != 0;
    drop_zeros=True (the default, for log parity) reproduces that quirk up
    to honoring the caller's n (the reference forces n=1 for nonzero
    values). An exactly-0.0 metric therefore does not enter the average —
    pass drop_zeros=False where that matters.
    """

    def __init__(self, drop_zeros: bool = True):
        self.drop_zeros = drop_zeros
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: float = 1):
        if self.drop_zeros and val == 0:
            n = 0
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0
