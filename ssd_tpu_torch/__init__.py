"""ssd_tpu_torch — the PyTorch / CUDA (H100) port of ``ssd_tpu``.

A second package beside the JAX one, with the same module layout so each
counterpart sits at the same path. It imports ``torch`` and numpy only —
never JAX, flax, orbax or anything under ``ssd_tpu`` — and keeps its own
copies of the framework-free modules it needs.

Ported so far (serving, training and evaluation; ROADMAP.md lists the
modules), among them the serving path, raw EMG → text:

* ``ops/featurizer.py`` — log-mel featurizer; its frame → mel → log core is
  the hand-written CUDA kernel ``csrc/logmel.cu`` on the card;
* ``models/`` — Conformer encoder, heads, ``build_model``, and
  ``flax_bridge.py`` to load the JAX package's weights;
* ``ops/ctc_decode.py`` — greedy and prefix beam search on the device;
* ``serving/`` — ``InferenceEngine``, the micro-batched HTTP server,
  chunked streaming (``streaming.py``, the ``/stream/*`` routes) and the
  ``torch.export`` serving artifact (``export.py``), whose graphs hold the
  serving kernels as the custom ops ``ssd_tpu_torch::logmel_core``,
  ``::attention_fwd`` and ``::depthwise_fwd``;
* ``training/checkpoint.py`` — the port's checkpoint format;
* ``decoding/ctc.py`` and ``evaluation/`` — the decoder factory, WER / CER
  and the eval CLI.

See ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
