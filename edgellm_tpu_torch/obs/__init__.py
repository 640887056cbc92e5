"""Observability (PyTorch counterpart of ``edgellm_tpu/obs``): so far the
typed metrics registry that ``--fault-report`` prints through."""
from .metrics import (Counter, Gauge, MetricsRegistry, format_table, record_link_counters,
                      record_link_health)

__all__ = ["Counter", "Gauge", "MetricsRegistry", "format_table", "record_link_counters",
           "record_link_health"]
