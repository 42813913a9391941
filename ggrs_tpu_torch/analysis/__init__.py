"""ggrs-verify for the port: the static-analysis plane over
``ggrs_tpu_torch/``.

The port's own copy of ``ggrs_tpu/analysis``: the same rules, rule ids,
``Finding`` fields and names, with every path table rooted at one
package prefix (``report.PKG``, ``"ggrs_tpu_torch"``) so the same code
judges either tree — handed ``pkg="ggrs_tpu"`` it reproduces the JAX
checker's findings.  Standard library only: no torch, no jax, nothing of
either package, so it judges a tree that does not import.

Three pillars, all source-level — they read the tree, not the process:

- :mod:`.layout` — the cross-language ABI/layout checker.  Parses the
  packed-format constants out of the package's own native sources
  (``csrc/host/*.cpp``, ``csrc/host/wire_common.h`` and the kernel
  ``csrc/digest.cu``; a tree that keeps its host sources elsewhere is
  judged with ``host=``) and the Python decoders
  (``net/_native.py``, ``net/messages.py``, ``net/sockets.py``,
  ``parallel/host_bank.py``, ``fleet/rpc.py``, ``ops/digest.py``) and
  proves the mirrored offsets/widths/flag bits/error codes/kernel
  limits agree — so layout drift fails lint, not a B=512 fleet.  The
  static table is additionally pinned equal to the runtime probes
  (``ggrs_bank_hdr_stride()``, ``ggrs_digest_limits()``) by
  ``scripts/port_verify.py`` and tests/test_torch_verify_layout.py.
- :mod:`.determinism` — an AST lint over rollback-visible code for the
  bit-identical-resimulation invariant: wall-clock reads, unseeded RNG
  (torch's process-global generator included), unordered-set
  iteration, salted ``hash()``, float-reduction hazards inside compiled
  sim code (jax/Pallas jit, ``torch.compile``, TorchScript,
  ``triton.jit``, CUDA-graph capture), unpinned pickles on the
  migration-bundle paths.  Violations carry rule ids; a committed
  baseline (``determinism_baseline.json``) lets legacy findings burn
  down while new ones fail.
- :mod:`.ownership` — a static companion to
  ``utils.ownership.ThreadOwned``: every mixin user must declare its
  driving methods (``_DRIVING_METHODS``) and every declared method must
  actually guard with ``_check_owner()`` (and vice versa), so the
  thread-affinity contract is visible to review and checkable without
  running the race.
- ggrs-model — the protocol state machines, machine-checked.
  :mod:`.model` is a deterministic explicit-state BFS engine (safety
  invariants, liveness-via-progress, replayable shortest
  counterexamples, state/time budgets); :mod:`.machines` builds the
  tree's real §9/§16/§17/§25/§26 machines from source and runs the
  :data:`~.machines.MODEL_CATALOG` (HEAD models must explore clean,
  known-broken fixtures like the old checkpoint ordering must
  keep their pinned counterexamples); :mod:`.conformance` is the
  static half — every setter site performs an edge of the declared
  ``SLOT_``/``PROC_``/``SHARD_``/``LINK_``/``MIG_TRANSITIONS`` tables.

``scripts/port_verify.py`` fronts all of it (plus tree-hygiene checks
and the runtime probes of the port's built libraries) with baseline
handling and a non-zero exit on new violations;
``scripts/port_build_sanitized.sh`` runs it before the port's
sanitizer legs and runs the model leg (``--model``) behind
``GGRS_SKIP_MODEL``.
"""

from .baseline import Baseline, load_baseline, write_baseline
from .conformance import (
    MACHINE_SPECS,
    TRANSITION_RULES,
    lint_transitions,
    parse_transition_table,
)
from .cpp import parse_cpp_constants
from .determinism import DETERMINISM_RULES, lint_determinism
from .layout import (
    LAYOUT_HEADER_FIELDS,
    check_layout,
    static_bank_header,
)
from .machines import MODEL_CATALOG, MODEL_RULES, check_models
from .model import (
    Action,
    CheckResult,
    Invariant,
    Model,
    ModelError,
    Progress,
    check,
    replay,
)
from .ownership import lint_ownership
from .pysrc import (
    parse_py_constants,
    parse_py_field_tuples,
    parse_py_struct_formats,
)
from .report import Finding

__all__ = [
    "Action",
    "Baseline",
    "CheckResult",
    "DETERMINISM_RULES",
    "Finding",
    "Invariant",
    "LAYOUT_HEADER_FIELDS",
    "MACHINE_SPECS",
    "MODEL_CATALOG",
    "MODEL_RULES",
    "Model",
    "ModelError",
    "Progress",
    "TRANSITION_RULES",
    "check",
    "check_layout",
    "check_models",
    "lint_determinism",
    "lint_ownership",
    "lint_transitions",
    "load_baseline",
    "parse_cpp_constants",
    "parse_py_constants",
    "parse_py_field_tuples",
    "parse_py_struct_formats",
    "parse_transition_table",
    "replay",
    "static_bank_header",
    "write_baseline",
]
