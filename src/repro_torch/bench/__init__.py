"""The paper's two-tier stack and the §V approaches (port of
``benchmarks/common.py``'s stack and ``benchmarks/approaches.py``)."""
