"""Serving-plane errors and the resume gate that the generation engine
imports.

The RPC server itself (``InferenceServer``, ``MicroBatcher``, ``serve()``
with its ``infer`` and ``generate`` verbs over TCP) waits for the port of
the frozen-Program stack it serves; until then the port's entry point
is ``engine.GenerationEngine`` called in-process.  These names and their
reply strings are the JAX package's, so errors read the same on the wire.
"""
from __future__ import annotations

import os


class Overloaded(RuntimeError):
    """Admission refused — queue full, draining, or the projected wait
    exceeds the request deadline. The CLIENT's cue to back off or go to
    another replica; the error string crosses the wire verbatim."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before its batch ran."""


class ResumedOnNewWeights(RuntimeError):
    """A generation resume landed on a replica serving a different
    weight epoch than the one the already-delivered tokens came from.
    Splicing two models' tokens would be silent corruption; the client
    gets this typed refusal (string crosses the wire verbatim) and
    decides — retry from scratch, or surface the partial output."""


# PADDLE_SERVE_RESUME=0 disables the resume/preempt machinery entirely —
# the engine sheds instead of preempting.
ENV_RESUME = "PADDLE_SERVE_RESUME"


def resume_enabled() -> bool:
    return os.environ.get(ENV_RESUME, "1") not in ("0", "false", "off")
