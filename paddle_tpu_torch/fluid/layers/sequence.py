"""Sequence layers: ``distributed_embedding`` only, ported from the JAX
package's ``fluid/layers/sequence.py``.  The rest of that file (the
ragged and beam-search layers) is not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["distributed_embedding"]


def distributed_embedding(input, table_name, name=None):
    """Look up rows of a host-resident PS table (distributed.ps) —
    reference layers distributed_lookup_table / fleet PS embedding.
    The table must have been created with distributed.ps.create_table;
    its optimizer runs server-side, so the program only carries a (1,)
    zero anchor Parameter that routes autodiff through the op."""
    from ...distributed import ps

    table = ps.get_table(table_name)
    helper = LayerHelper("distributed_embedding", name=name)
    anchor = helper.create_parameter(
        ParamAttr(name=f"{table_name}_anchor",
                  initializer=ConstantInitializer(0.0)),
        shape=[1], dtype="float32",
    )
    out = helper.create_variable_for_type_inference(str(np.dtype(table.dtype)))
    helper.append_op(
        type="distributed_lookup_table",
        inputs={"Ids": [input], "W": [anchor]},
        outputs={"Outputs": [out]},
        attrs={"table_names": [table_name]},
    )
    return out
