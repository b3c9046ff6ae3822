"""One-way importers: the reference's torch state dicts -> the flax
variable trees of the JAX package (``svdd_tpu/importers/``), as nested
dicts of numpy arrays, which ``weights.*_from_jax`` carry into the
port's modules. The name maps are the JAX importers', kept here in
numpy alone (the port imports nothing of JAX)."""

from svdd_tpu_torch.importers.cnn import import_cnn_params  # noqa: F401
from svdd_tpu_torch.importers.convgru import (  # noqa: F401
    import_bidirectional_gru, import_convgru_value_model, import_gru_cell)
from svdd_tpu_torch.importers.dit import import_dit_params  # noqa: F401
from svdd_tpu_torch.importers.enformer import (  # noqa: F401
    import_enformer_value_model)
