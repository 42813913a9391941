#!/usr/bin/env python3
"""Fleet shard runner of the PyTorch port: one ``PoolShard`` serving loop
as a real OS process.

Spawned by ``ggrs_tpu_torch.fleet.ShardSupervisor`` for its
``proc_shards`` (socketpair fd handed down via ``--fd``), or started
standalone for the supervisor to adopt:

  python scripts/port_shard_runner.py --uds /run/ggrs/shard0.sock
  GGRS_FLEET_LINK_AUTH_TOKEN=t GGRS_FLEET_LINK_SHARD=s1 \\
      python scripts/port_shard_runner.py --tcp host:port [--ingress]

Everything else (the frame protocol, the ops, heartbeats, the SIGTERM
drain) lives in ``ggrs_tpu_torch.fleet.proc.ShardRunner``.  The runner
imports torch and numpy, never jax.  On a machine with a CUDA card it
opens its CUDA context and loads the digest kernel's library before it
serves, so the first ``admit`` or ``tick`` call pays neither (the library
is built at first use; in a fleet the parent builds it before spawning).

Exit code 0 = drained (signal or supervisor-requested shutdown);
1 = the supervisor vanished or the control stream was poisoned.  After
either, the exit hooks run and the process leaves without the interpreter's
teardown (see the end of this file).
"""

import atexit
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from ggrs_tpu_torch.fleet.proc import runner_main  # noqa: E402
from ggrs_tpu_torch.ops import digest  # noqa: E402


def warm_card() -> None:
    """Open this process's CUDA context and load the digest library (built
    at first use) before serving: both take longer than one RPC's
    deadline.  Nothing happens without a card."""
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        digest._lib()


if __name__ == "__main__":
    warm_card()
    code = runner_main()
    # runner_main returns after the drain (journals flushed, fsynced and
    # closed, goodbye sent) or a fatal link error: run the exit hooks, flush,
    # and leave without the interpreter's teardown, which with torch loaded
    # takes about 0.6 s, longer than a supervisor's drain deadline may allow
    # before it escalates to SIGKILL
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
