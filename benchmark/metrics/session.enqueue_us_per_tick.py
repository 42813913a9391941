"""session.enqueue_us_per_tick: the host's part of a tick before it waits
for the card, in microseconds.  In the traced run, before the profiler
starts, a second of closed-loop ticks is run with each call split at its
read: ``run_ticks(check=False)``, timed, then the session's ``verify()``,
which together are ``run_ticks(check=True)`` for both entries.  The timed
part holds the same work for both: the inputs' upload, the split at
warm-up and the replay's launch, and for a batch the eager reduction of
its counts (one session stacks its two counts inside ``verify``), up to
the read of the mismatch count.  The host clock sums it over the ticks, with no tracer
running, and the mean a tick is read here.  Moves ``tick_ms_p95``."""


def read(ctx):
    us = ctx["enqueue_us"]
    return us if us > 0 else None
