"""Response post-processing filters (parity surface: reference src/data/filters/).

A filter transforms the list-of-response-lists for a task's instances; a
``FilterEnsemble`` chains filters and writes each instance's
``filtered_resps[ensemble_name]``.
"""

from lmms_owc_tpu_torch.filters._api import (
    FILTERS,
    Filter,
    FilterEnsemble,
    get_filter,
    get_filters_ensemble,
    register_filter,
)
from lmms_owc_tpu_torch.filters import _extraction, _selection, _transformation  # noqa: F401  (register)

__all__ = [
    "FILTERS",
    "Filter",
    "FilterEnsemble",
    "get_filter",
    "get_filters_ensemble",
    "register_filter",
]
