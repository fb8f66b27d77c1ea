"""positcheck for the port -- repo-invariant static analyzer of ``repro_torch``.

Pure-stdlib (``ast`` + ``re``): ``python -m repro_torch.analysis``
imports no ``torch`` (the package's ``__init__`` holds only a docstring),
so a lint job runs it without one.

The rule ids and bug classes are the reference's (``repro.analysis``);
their targets are the port's idioms:

- PVU001 -- an index write (subscript assignment, ``index_copy_``,
  ``index_fill_``, ``index_put_``) into a cache, arena or KV tensor
  outside the writers that drop sentinel and out-of-range slots: a
  PyTorch index of -1 wraps to the last slot, as the reference's
  ``dynamic_update_slice`` clamped onto it.
- PVU002 -- dequant->f32->requant round-trips outside ``kernels/`` and
  ``compress/`` (the fused posit kernels replace them).
- PVU003 -- ``.dtype`` comparisons or ``is_floating_point()`` on cache
  leaves instead of the ``CONTENT_LEAVES``/``META_LEAVES`` schema.
- PVU004 -- a host sync (``nonzero``, ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``) in ``models/`` or ``kernels/``, the code a
  captured decode step runs.
- PVU005 -- ``BlockPool`` private allocator state outside
  ``compress/kvcache.py``.
- PVU006 -- a dispatch key, ``lru_cache`` or
  ``torch.compile(dynamic=False)`` keyed on a prompt-length-like name
  outside ``runtime/engine.py``.
- PVU007 -- a cache or arena created with ``torch.zeros/empty/full`` in
  ``runtime/`` or ``models/`` outside ``init*`` functions and functions
  given the mesh or the shards, or moved whole to a device beside a mesh.

Findings are waivable per line with ``# positcheck: disable=PVU001``
(comma-separated ids, or ``all``).  The waiver must sit on the line the
finding points at or on the first line of the flagged statement.  The
reference's analyzer (``python -m repro.analysis src``) scans this
package too and reads the same comments, so a waiver here also silences
the reference's rule of the same id on that line.
"""

from .core import Finding, ModuleFile, Rule, run_paths  # noqa: F401
from .rules import ALL_RULES, rule_by_id  # noqa: F401
