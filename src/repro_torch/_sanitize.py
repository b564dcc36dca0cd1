"""Bridge from ``src/repro_torch`` to the optional sanitizer rails.

The port's own copy of ``repro/_sanitize.py``.  The serving hot paths
call :func:`load` and get either the ``tools.analysis.sanitize`` module or
``None``; everything downstream is gated on that, so with
``REPRO_SANITIZE`` unset (or a checkout without ``tools/``) a hook costs
one ``os.environ`` lookup and nothing else.

``tools.analysis.sanitize`` is framework-free (hashlib, os, collections):
it is the port's one import outside torch, numpy and the standard library,
and it happens only when ``REPRO_SANITIZE`` is set, at call time, never
when a module is imported.

``tools`` is importable under pytest (the repo root is the rootdir) but
not from standalone scripts run as ``PYTHONPATH=src python ...``, so the
bridge puts the repo root on ``sys.path`` when needed.
"""

from __future__ import annotations

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def load():
    """Return the sanitize module when the rails are enabled, else None."""
    if not enabled():
        return None
    try:
        from tools.analysis import sanitize
    except ImportError:
        if _REPO_ROOT in sys.path:
            return None
        sys.path.insert(0, _REPO_ROOT)
        try:
            from tools.analysis import sanitize
        except ImportError:
            return None
    return sanitize
