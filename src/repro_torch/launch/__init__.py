"""Entry points of the port: the training driver (``train``), the serve
runtime (``serve``, over the slot-pool steps of ``steps``) and the round
profiler (``profile_round``)."""
