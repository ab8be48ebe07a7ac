"""Streaming time-series subsystem (DESIGN.md §14). Counterpart of
``repro/timeseries``: synthetic multichannel vitals/stress streams
(``stream``), the analog feature front-end spec and featurize path
(``feature``), and the sensor -> feature -> ADC -> classifier co-search
(``cosearch``).

``feature`` and ``stream`` do not depend on the search or deploy layers,
so ``core/search.py`` and ``core/deploy.py`` import them without cycles;
``cosearch`` imports the search layer and is loaded lazily by
``repro_torch.api.cosearch``.
"""
from repro_torch.timeseries.feature import FeatureSpec, featurize  # noqa: F401
from repro_torch.timeseries.stream import StreamSpec, make_stream  # noqa: F401
