"""ssd_tpu_torch — the PyTorch / CUDA (H100) port of ``ssd_tpu``.

A second package beside the JAX one, with the same module layout so each
counterpart sits at the same path. It imports ``torch`` and numpy only —
never JAX, flax, orbax or anything under ``ssd_tpu`` — and keeps its own
copies of the framework-free modules it needs.

Ported so far (the serving path, raw EMG → text):

* ``ops/featurizer.py`` — log-mel featurizer; its frame → mel → log core is
  the hand-written CUDA kernel ``csrc/logmel.cu`` on the card;
* ``models/`` — Conformer encoder, heads, ``build_model``, and
  ``flax_bridge.py`` to load the JAX package's weights;
* ``ops/ctc_decode.py`` — greedy and prefix beam search on the device;
* ``serving/`` — ``InferenceEngine`` and the micro-batched HTTP server;
* ``training/checkpoint.py`` — the port's checkpoint format.

See ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
