"""The expressivity experiments on the port (twins of the repository's
``examples/kchains.py``, ``rotsym.py`` and ``incompleteness.py``), each run
as ``python -m geometric_message_passing_tpu_torch.examples.<name>``."""
