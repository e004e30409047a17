"""Continuous learning on the serving stream (port of the reference's
`online/`).

The middle of the closed loop: `StreamingEvaluator` joins delayed labels
to served predictions, `install_model` hot-swaps with zero dropped
requests, `RolloutDriver` canary-gates; this package feeds the joined
pairs back into training on the card and ships the result.

- `learner`: `OnlineLearner`, incremental VW updates on a fixed (rows, k)
  shape bucket, its state on the card.
- `stream`: `LabelFeed`, a bounded minibatch buffer on evaluator joins.
- `loop`: `ContinuousLearner`, drift trip / floor burn -> refit -> canary
  gate -> promote or rollback, every transition journaled.
"""
from .learner import OnlineLearner
from .loop import (ContinuousLearner, ContinuousLearnerMachine,
                   OnlineAction, OnlineConfig, OnlineObservation)
from .stream import LabelFeed

__all__ = ["OnlineLearner", "LabelFeed", "ContinuousLearner",
           "ContinuousLearnerMachine", "OnlineAction", "OnlineConfig",
           "OnlineObservation"]
