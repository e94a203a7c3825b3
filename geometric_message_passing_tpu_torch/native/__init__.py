"""The host C++ graph code (port of the JAX package's ``native/``): the
epoch batcher, the triplet enumerator and the radius graph's cell list, in
``csrc/host/`` and built by ``ops/_host_build.py``.  Unlike the JAX
package, nothing here falls back to numpy: a failed build raises."""

from .batch import FlatDataset, fast_build_batches, fast_build_triplets  # noqa
