"""The featurize plane, the port of the JAX package's ``featurize/``: the
raw-to-vector plane with its host hot loops in native code.

* **token interning** (``interning``): a text column tokenized once into
  int32 codes + row offsets over a per-batch vocabulary;
* **code kernels** (``kernels``): the interned scatters, calendar periods;
* **fused block assembly** (``engine``): the vectorizers feeding the one
  ``VectorsCombiner`` write into one preallocated ``[N, width]`` buffer;
* **chunked parallel featurization** (``parallel``): a thread pool over
  row chunks (the native kernels release the interpreter lock);
* **featurizeStats** (``stats``): the process-wide ledger, reported in the
  selector summary and ``score_function(...).metadata()``;
* the quantized serving plane of the fused scoring graph (``quantize``).

The native kernels are ``native/tptpu_native.cpp``, built and bound by the
port's ``native.py``.
"""
