"""Data, NumPy only: the inference reader and its preprocessing, the
training reader (``datasets``, with ``sampling`` and ``containment``), the
prefetcher, and the synthetic subjects and training trees."""
