"""Shared teardown for the aiohttp-in-a-daemon-thread servers.

The port's copy of ``ray_tpu/utils/eventloop.py``.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch.utils.logging import get_logger, log_swallowed


def drain_and_close_loop(loop: asyncio.AbstractEventLoop,
                         logger_name: str) -> None:
    """Join the loop's default-executor workers, then close the loop.

    ``loop.close()`` alone abandons the ``run_in_executor`` pool — one
    leaked set of worker threads per server restart.
    """
    try:
        loop.run_until_complete(loop.shutdown_default_executor())
    except Exception:  # noqa: BLE001 — close() still shuts it down
        log_swallowed(get_logger(logger_name), "default-executor shutdown")
    loop.close()
