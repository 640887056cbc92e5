"""Token- and head-importance scoring.

``metrics`` — attention-statistic metrics (column mean, last row, aggregates)
that consume the reduced :class:`~edgellm_tpu_torch.models.transformer.AttnStats`
captured by the model forward. ``relevance`` — LRP attention-head relevance
(the reference's ``lxt`` path) as autograd rules; imported on its own
(``from edgellm_tpu_torch.importance.relevance import ...``), as the CLI does.
"""
from .metrics import (
    ATTENTION_METHODS,
    regular_importance,
    weighted_importance,
    last_row_importance,
    aggregate_till,
    importance_per_layer,
    aggregate_upto,
    maximum_aggregation,
    ordering_from_importance,
)

__all__ = [
    "ATTENTION_METHODS",
    "regular_importance",
    "weighted_importance",
    "last_row_importance",
    "aggregate_till",
    "importance_per_layer",
    "aggregate_upto",
    "maximum_aggregation",
    "ordering_from_importance",
]
