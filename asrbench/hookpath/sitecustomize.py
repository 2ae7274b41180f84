"""Interpreter-start hook of the processes the benchmark starts.

The harness puts this directory first on ``PYTHONPATH`` and names a
settings file in ``ASRBENCH_HOOK``; every Python process started with
that environment (the program's CLI, and under ``launch`` each rank)
runs ``asrbench.hook.install``, which acts only in the process whose
command runs the settings' ``entry`` module, before its ``main``.
Without the variable it does nothing.  Any other ``sitecustomize``
further down the path still runs.
"""

import importlib.machinery
import importlib.util
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize",
    [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _prev = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_prev)

if os.environ.get("ASRBENCH_HOOK"):
    from asrbench import hook

    hook.install(os.environ["ASRBENCH_HOOK"])
