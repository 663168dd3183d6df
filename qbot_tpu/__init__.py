"""qbot_tpu — a JAX runtime for the qbot probabilistic-quantum DSL.

Public embedding API (parity with the reference package surface,
/root/reference/qbot/__init__.py:1-9): ``executeFile``, ``executeTxt``,
``main``, ``__version__``.  ``executeTxt``/``executeFile`` return the final
program namespace (``state`` = final density matrix, user variables at top
level).
"""
from qbot_tpu.frontend.ensemble import executeTxtEnsemble
from qbot_tpu.frontend.interpreter import executeFile, executeTxt

__version__ = "0.1.0"


def main():
    import sys

    from qbot_tpu.cli import main as _cli_main
    sys.exit(_cli_main())


__all__ = ["executeFile", "executeTxt", "executeTxtEnsemble", "main",
           "__version__"]
