"""Examples on the port, each run as ``python -m
geometric_message_passing_tpu_torch.examples.<name>``: the expressivity
experiments (twins of the repository's ``examples/kchains.py``,
``rotsym.py`` and ``incompleteness.py``), the QM9-style pipeline
(``qm9_pipeline``), the 101 notebook's code (``gnn101``) and the generators
of the notebooks in ``notebooks/`` (``make_101_notebook``,
``make_experiment_notebooks``)."""
