"""Pass-sandwich verification (the MLIR verifier convention).

Wrap a graph rewrite so the program is verified BEFORE and AFTER it
runs; error findings that were not present before are attributed to the
pass and raised. Gated on FLAGS_program_verify: flag-off, the context
manager is a flag lookup and nothing else — the rewrite paths stay
bit-identical to a build without this module.
"""
from __future__ import annotations

import contextlib
from typing import Iterable

from ..flags import flag
from .core import ERROR, ProgramVerifyError, verify_program


@contextlib.contextmanager
def pass_sandwich(program, pass_name: str, live_out: Iterable[str] = ()):
    if not flag("FLAGS_program_verify"):
        yield
        return
    before = verify_program(program, live_out=live_out)
    if any(f.severity == ERROR for f in before):
        # the input was already broken: attribute to the producer of the
        # program, not to this pass — earliest-possible diagnosis
        raise ProgramVerifyError(before,
                                 where=f"input of pass {pass_name!r}")
    seen = {f.key() for f in before}
    yield
    after = verify_program(program, live_out=live_out)
    new_errors = [f for f in after
                  if f.severity == ERROR and f.key() not in seen]
    if new_errors:
        for f in new_errors:
            f.pass_name = pass_name
        raise ProgramVerifyError(new_errors,
                                 where=f"after pass {pass_name!r}")
