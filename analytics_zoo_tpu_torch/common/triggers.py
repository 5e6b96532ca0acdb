"""Training triggers — a copy of ``analytics_zoo_tpu/common/triggers.py``
(pure Python): the reference's ``ZooTrigger`` family
(``common/ZooTrigger.scala:30-82``) and BigDL's ``Trigger``.

A trigger is a predicate over the training loop state deciding when to stop,
checkpoint, or validate. The reference's triggers are "aware of data slicing"
(DiskFeatureSet epochs, ``FeatureSet.scala:332-409``); here ``TrainState``
carries both the global step and the (possibly fractional) epoch so the same
semantics hold for sliced datasets.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainLoopState:
    """Mutable loop bookkeeping passed to triggers."""

    iteration: int = 0           # global optimizer steps taken
    epoch: int = 1               # 1-based, like BigDL's Trigger.everyEpoch
    epoch_finished: bool = False # True exactly at an epoch boundary


class Trigger:
    def __call__(self, state: TrainLoopState) -> bool:  # pragma: no cover
        raise NotImplementedError


class EveryEpoch(Trigger):
    """Fires at every epoch boundary (``ZooTrigger.scala:44``)."""

    def __call__(self, state: TrainLoopState) -> bool:
        return state.epoch_finished


class SeveralIteration(Trigger):
    """Fires every ``interval`` optimizer steps (``ZooTrigger.scala:66``)."""

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, state: TrainLoopState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


class MaxEpoch(Trigger):
    """End-trigger: stop once ``max_epoch`` epochs finished."""

    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state: TrainLoopState) -> bool:
        # at a boundary the finished count IS state.epoch; mid-epoch the
        # current epoch has not finished yet
        if state.epoch_finished:
            return state.epoch >= self.max_epoch
        return state.epoch > self.max_epoch


class MaxIteration(Trigger):
    """End-trigger: stop after ``max_iteration`` steps."""

    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state: TrainLoopState) -> bool:
        return state.iteration >= self.max_iteration


class MinLoss(Trigger):
    """End-trigger: stop once the running loss drops below ``min_loss``."""

    def __init__(self, min_loss: float):
        self.min_loss = min_loss
        self.last_loss = float("inf")

    def record(self, loss: float) -> None:
        self.last_loss = loss

    def __call__(self, state: TrainLoopState) -> bool:
        return self.last_loss < self.min_loss


class And(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, state: TrainLoopState) -> bool:
        return all(t(state) for t in self.triggers)


class Or(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, state: TrainLoopState) -> bool:
        return any(t(state) for t in self.triggers)
