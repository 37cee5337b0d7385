"""dynamo_tpu_torch — the serving engine in PyTorch, with CUDA kernels for Hopper.

The package mirrors ``dynamo_tpu``'s layout module for module
(``dynamo_tpu_torch/engine/core.py`` is the counterpart of
``dynamo_tpu/engine/core.py``, and so on) but imports nothing of it and no
JAX.  Plain tensor code is PyTorch; the kernels the serving paths run are
CUDA C++ under ``csrc/``, compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/kernels/build.py``).

Entry points (``python -m dynamo_tpu_torch run``, ``EngineCore``,
``LlamaModel``, ``models.convert.init_params``, ``models.loader``) run on
``cuda`` unless the caller passes ``device="cpu"`` (``--device cpu``); with
no device given and no GPU present they raise instead of carrying on on
the CPU.
"""
