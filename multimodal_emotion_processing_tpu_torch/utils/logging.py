"""Run logs: one CSV of epoch losses per member (the reference's txt
channel, cmu-mosei/run.py:394-396,411-412), mirrored to TensorBoard
scalars (its SummaryWriter channel) when `torch.utils.tensorboard`
imports (utils/logging.py of the JAX package)."""

from __future__ import annotations

import os


class RunLogger:
    """Writes `<dir>/<name>.csv` with epoch,train_loss,valid_loss,
    samples_per_sec and mirrors the losses to TensorBoard when available."""

    def __init__(self, log_dir: str, name: str, *, tensorboard: bool = True):
        """TensorBoard mirrors by default, as the reference always writes
        its scalars beside the txt log (cmu-mosei/run.py:397,408); without
        an importable writer the log is the CSV alone."""
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.csv")
        self.name = name
        with open(self.path, "w") as f:
            f.write("epoch,train_loss,valid_loss,samples_per_sec\n")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log_epoch(self, epoch: int, stats) -> None:
        with open(self.path, "a") as f:
            f.write(f"{epoch + 1},{stats.train_loss:.6f},{stats.valid_loss:.6f},"
                    f"{stats.samples_per_sec:.2f}\n")
        if self._tb is not None:
            self._tb.add_scalars(self.name, {"train_loss": stats.train_loss,
                                             "valid_loss": stats.valid_loss}, epoch)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
