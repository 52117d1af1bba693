"""The serving tier of the port: continuous batching on the card.

* ``infer.py``     — preprocess / forward / postprocess;
* ``bucketing.py`` — the padded-batch bucket ladder;
* ``policy.py``, ``queue.py`` — the continuous-batching queue and its
  pure flush/admission policy;
* ``engine.py``    — per-replica forwards over the cards, with streams;
* ``server.py``    — placement → dispatch → completion drain, with the
  in-process relaunch supervisor;
* ``metrics.py``   — per-request accounting (p50/p99, imgs/s);
* ``cli.py``       — the stdlib HTTP surface.
"""

from distributedpytorch_tpu_torch.serve.bucketing import BucketPlanner  # noqa: F401
from distributedpytorch_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from distributedpytorch_tpu_torch.serve.queue import (  # noqa: F401
    REJECT_OVERLOAD,
    REJECT_SHUTDOWN,
    REJECT_TOO_LARGE,
    BatchingQueue,
    ServeRequest,
)
