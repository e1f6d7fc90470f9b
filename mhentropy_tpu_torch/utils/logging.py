"""The experiment's meters, logger and scalar writer.

Port of mhentropy_tpu/utils/logging.py: `AverageMeter` (:23-49), the
reference's meter (utils.py:75-91) with its quirk of dropping zero-valued
updates, on by default for log parity; `get_logger` (:52), python logging
to a file and stdout; `ScalarWriter` (:79), TensorBoard scalars through
tensorboardX where it imports (a lazy, optional import) and always a JSONL
record, `scalars.jsonl`; and the run-option printers `print_args` (:109)
and `save_args` (:118). The port keeps its own copy so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


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


def get_logger(filename: str, verbosity: int = 1, name: str | None = None) -> logging.Logger:
    """A logger named `name` (default: the file name) that writes to
    `filename` (truncated) and to stdout; called again, it closes and
    replaces the handlers it had."""
    level = {0: logging.DEBUG, 1: logging.INFO, 2: logging.WARNING}[verbosity]
    fmt = logging.Formatter(
        "[%(asctime)s][%(filename)s][line:%(lineno)d][%(levelname)s] %(message)s")
    logger = logging.getLogger(name or filename)
    logger.setLevel(level)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    fh = logging.FileHandler(filename, "w")
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


class ScalarWriter:
    """TensorBoard scalar writer with a JSONL record: every scalar is
    appended to `<logdir>/scalars.jsonl` as {"tag", "value", "step", "ts"},
    and also to a tensorboardX event file where tensorboardX imports."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except ImportError:
            pass
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": int(global_step),
                                      "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


def print_args(args):
    """(manopth/argutils.py:8-13)."""
    opts = vars(args) if not isinstance(args, dict) else args
    print("======= Options ========")
    for k, v in sorted(opts.items()):
        print(f"{k}: {v}")
    print("========================")


def save_args(args, save_folder: str, opt_prefix: str = "opt",
              verbose: bool = True):
    """Persist run options + git state (manopth/argutils.py:16-51)."""
    import datetime
    import pickle
    import subprocess

    opts = vars(args) if not isinstance(args, dict) else args
    os.makedirs(save_folder, exist_ok=True)
    opt_path = os.path.join(save_folder, f"{opt_prefix}.txt")
    with open(opt_path, "a") as fp:
        fp.write("====== Options ======\n")
        for k, v in sorted(opts.items()):
            fp.write(f"{k}: {v}\n")
        fp.write("=====================\n")
        fp.write(f"launched {sys.argv[0]} at {datetime.datetime.now()}\n")
        try:
            label = subprocess.check_output(
                ["git", "describe", "--always"], stderr=subprocess.DEVNULL
            ).strip()
            commit = subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
            ).strip()
            fp.write("=== Git info ====\n")
            fp.write(f"{label.decode()}\ncommit : {commit.decode()}\n")
        except Exception:
            pass
    with open(os.path.join(save_folder, f"{opt_prefix}.pkl"), "wb") as fp:
        pickle.dump(opts, fp)
    if verbose:
        print(f"Saved options to {opt_path}")
