"""Multi-process runtime of the port: the process group under torchrun
(``runtime.py``) and the collectives of data-parallel training
(``collectives.py``)."""
