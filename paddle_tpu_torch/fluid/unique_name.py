"""Unique name generator.

Parity surface: python/paddle/fluid/unique_name.py in the reference
(generate/guard/switch). Used by LayerHelper to name temporary variables,
parameters, and ops.

A copy of the JAX package's ``fluid/unique_name.py``: under
``guard()`` both packages name a program's temporaries alike, so two
builds of one model can be compared op by op.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator: UniqueNameGenerator | None = None) -> UniqueNameGenerator:
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
