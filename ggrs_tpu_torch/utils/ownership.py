"""Thread-ownership guard for sessions (the port's copy of
``ggrs_tpu/utils/ownership.py``).

Sessions are ``Send`` but not ``Sync`` in the reference (GGRS
src/lib.rs:204-240): they may be handed off between threads but never
driven from two at once.  Sessions mix this guard in: the first driving
call pins the owning thread, later calls from any other thread raise
``CrossThreadAccess``, and ``transfer_ownership()`` hands a session to the
calling thread.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..core.errors import CrossThreadAccess

# guards only the one-time None -> owner transition, so two threads racing
# their first driving call cannot both claim the session
_pin_lock = threading.Lock()


class ThreadOwned:
    """Mixin: pin driving calls to one thread at a time.  Subclasses list
    the methods that guard with ``_check_owner`` in ``_DRIVING_METHODS``."""

    _DRIVING_METHODS: tuple = ()
    _owner_ident: Optional[int] = None

    def _check_owner(self) -> None:
        owner = self._owner_ident
        if owner is None:
            with _pin_lock:
                if self._owner_ident is None:
                    self._owner_ident = threading.get_ident()
                    return
                owner = self._owner_ident
        if owner != threading.get_ident():
            raise CrossThreadAccess()

    def transfer_ownership(self) -> None:
        """Re-pin this session to the calling thread.  Call from the new
        thread, after the previous one has stopped driving the session."""
        self._owner_ident = threading.get_ident()
