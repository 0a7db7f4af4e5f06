"""Mean queue wait (ms) of the window's requests at the continuous server
(``parallel/llm_server.py``): the program's own ``t_admit - t_enqueue``."""

from benchmark.metrics._common import queue_wait_ms as read  # noqa: F401
