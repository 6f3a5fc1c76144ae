"""The NumPy oracle of the reference's semantics: the filter chain
(``filters``) and the footprint and path queries (``footprint``)."""

from traversability_estimation_tpu_torch.oracle import filters  # noqa: F401
