"""Step logging and the reference's results-file contract (port of
``egm_unet_tpu/utils/logging.py``).

``ResultsWriter`` appends per-epoch blocks to ``results{timestamp}.txt`` in
the reference's format, byte for byte the JAX package's for the same
numbers: the epoch, train loss and lr lines, the dice line, the
confusion-matrix block.  ``MetricLogger`` is a windowed meter with an ETA
that prints every ``print_freq`` iterations.  Data parallel, both write on
rank 0 only (``writer=False`` elsewhere).
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Iterable


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  ", writer: bool = True):
        self.meters = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print if writer else (lambda *a, **k: None)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                meters = self.delimiter.join(
                    f"{k}: {m.value:.4f} ({m.global_avg:.4f})" for k, m in self.meters.items())
                self.print(f"{header} [{i}{'/' + str(total) if total else ''}]  {eta}{meters}  "
                      f"time: {iter_time.avg:.4f}s")
            i += 1
            end = time.time()
        self.print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(time.time() - start))}")


class ResultsWriter:
    def __init__(self, path: str | None = None, writer: bool = True):
        ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.path = path or f"results{ts}.txt"
        self.writer = writer

    def write_epoch(self, epoch: int, mean_loss: float, lr: float,
                    confmat_block: str, dice: float):
        if not self.writer:
            return
        info = (f"[epoch: {epoch}]\n"
                f"train_loss: {mean_loss:.4f}\n"
                f"lr: {lr:.6f}\n"
                f"dice coefficient: {dice:.3f}\n")
        with open(self.path, "a") as f:
            f.write(info + confmat_block + "\n\n")
