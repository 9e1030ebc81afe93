"""Training checkpoints with the reference's cadence (port of
``egm_unet_tpu/utils/checkpoint.py``): save every ``period`` epochs, at the
last epoch, and whenever the validation dice improves; resume restores the
model (parameters and BatchNorm statistics), the optimiser's momentum
buffers, the schedule, the step count and the epoch.

Layout of a directory: ``<epoch>/checkpoint.pt`` (``torch.save`` of the
train state, the epoch and the best dice so far), ``meta.json`` (the run's
arguments), ``best_epoch.txt`` (``"<epoch> <dice>"`` of the best save).
The JAX package's orbax directories are not read: orbax needs JAX, which
this package does not import.  A JAX state crosses over as a flax tree of
numpy arrays (``utils/from_flax.py``).

Data parallel, only rank 0 writes (``writer=False`` on the others: the
cadence and the best dice are tracked, nothing is written) and every rank
restores.

``folded_state_dict`` turns a directory's best (else latest) epoch into the
``state_dict`` of the BN-folded inference graph, which ``serving.Predictor``
and ``cli/predict.py --weights`` load.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch

from egm_unet_torch.models.fold_bn import fold_bn_variables
from egm_unet_torch.models.registry import create_model
from egm_unet_torch.utils.from_flax import flax_from_state_dict, state_dict_from_flax

CHECKPOINT_FILE = "checkpoint.pt"


def saved_epochs(directory: str) -> list:
    """The epochs with a checkpoint in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(directory, d, CHECKPOINT_FILE)))


def best_epoch(directory: str) -> Optional[int]:
    """The epoch ``best_epoch.txt`` names, if its checkpoint exists."""
    path = os.path.join(directory, "best_epoch.txt")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        epoch = int(f.read().split()[0])
    return epoch if epoch in saved_epochs(directory) else None


def load_payload(directory: str, epoch: Optional[int] = None) -> dict:
    """The saved payload of ``epoch`` (default: the latest) on the CPU."""
    epochs = saved_epochs(directory)
    if epoch is None:
        if not epochs:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        epoch = epochs[-1]
    path = os.path.join(directory, str(epoch), CHECKPOINT_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, period: int = 100, writer: bool = True):
        self.directory = os.path.abspath(directory)
        self.writer = writer
        if writer:
            os.makedirs(self.directory, exist_ok=True)
        self.period = period
        self.best_dice = -1.0

    def maybe_save(self, epoch: int, total_epochs: int, state: Any,
                   dice: Optional[float] = None, extra: Optional[dict] = None):
        """Apply the cadence policy to ``state`` (an ``engine.TrainState``);
        returns the tags saved (``"best"`` or ``"periodic"``)."""
        tags = []
        is_best = dice is not None and dice > self.best_dice
        if is_best:
            self.best_dice = float(dice)
        if not ((epoch + 1) % self.period == 0 or epoch == total_epochs - 1
                or is_best):
            return tags
        tags.append("best" if is_best else "periodic")
        if not self.writer:
            return tags
        payload = {"state": state.state_dict(), "epoch": epoch,
                   "best_dice": self.best_dice}
        out = os.path.join(self.directory, str(epoch))
        os.makedirs(out, exist_ok=True)
        tmp = os.path.join(out, CHECKPOINT_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(out, CHECKPOINT_FILE))
        if extra:  # non-tensor metadata (the arguments) as a JSON sidecar
            with open(os.path.join(self.directory, "meta.json"), "w") as f:
                json.dump(extra, f, indent=2, default=str)
        if is_best:
            with open(os.path.join(self.directory, "best_epoch.txt"), "w") as f:
                f.write(f"{epoch} {self.best_dice}\n")
        return tags

    def latest_epoch(self) -> Optional[int]:
        epochs = saved_epochs(self.directory)
        return epochs[-1] if epochs else None

    def restore(self, state: Any, epoch: Optional[int] = None) -> dict:
        """Load ``epoch`` (default: the latest) into ``state`` in place;
        returns ``{"state", "epoch", "best_dice"}``."""
        payload = load_payload(self.directory, epoch)
        state.load_state_dict(payload["state"])
        self.best_dice = float(payload.get("best_dice", -1.0))
        return {"state": state, "epoch": int(payload["epoch"]),
                "best_dice": self.best_dice}

    def close(self) -> None:
        """Nothing stays open between saves."""


def folded_state_dict(directory: str, model_name: str, num_classes: int,
                      base_c: int) -> dict:
    """The BN-folded inference graph's ``state_dict`` from a trainer's
    directory: its best epoch, else its latest, through
    ``flax_from_state_dict`` and ``models.fold_bn.fold_bn_variables``."""
    payload = load_payload(directory, best_epoch(directory))
    kw = dict(num_classes=num_classes, base_c=base_c)
    train_graph = create_model(model_name, fold_bn=False, **kw)
    tree = flax_from_state_dict(train_graph, payload["state"]["model"])
    return state_dict_from_flax(create_model(model_name, **kw),
                                fold_bn_variables(tree))
