"""Multi-process parts of the port: the landmark-sharded global BA
(``dist_ba``) and its worker entry point (``dist_worker``)."""
