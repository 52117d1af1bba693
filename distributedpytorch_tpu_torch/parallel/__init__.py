"""Training strategies of the port (``strategy.py``)."""
