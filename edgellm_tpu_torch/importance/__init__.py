"""Token-importance scoring from the forward pass's attention statistics."""
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
