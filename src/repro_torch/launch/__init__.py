"""Entry points of the port: the training driver (``train``), the serve
runtime (``serve``, over the slot-pool steps of ``steps``), the round
profiler (``profile_round``), and the cost model (``analytic``,
``hlo_cost``) with its dry run (``dryrun``)."""
