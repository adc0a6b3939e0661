"""The decode step replayed from a CUDA graph.

``MakeAScene.decode_step`` runs its body (``MakeAScene.decode_body``,
which reads the image position from a device tensor) through
``DecodeGraph.run``.  On the card, step 0 of a batch runs eagerly on a
side stream, which also warms that stream for the capture; step 1
captures the body over the batch's caches; every step from 1 on replays
the graph: one launch in place of the step's ~1,250 operator calls, the
same kernels in the same order.  Before each replay the token is copied
into the graph's static input and the step written into a persistent
int32 device tensor (``fill_``: a launch that carries the value, so no
host value is read on the device's side); the logits are cloned out of
the static output, so the next replay does not overwrite what the caller
holds.  A graph holds no host state of the step: the sampling head stays
outside it, drawing from its explicit ``torch.Generator``.

B2, B3, B10 and B9 bake the caches' addresses into their launches, so a
graph is keyed on the token's shape, dtype and device and on the address,
shape, strides, dtype and device of every tensor of every layer's decode
state (``tensors()``, ``models/decode_state.py``), and captured anew when
they change; it is also captured anew at step 1 of
every batch, since the Python that the step runs may differ from one
batch to the next (a kernel function patched for its plain twin, a
parameter's storage replaced).  The captures share one memory pool, and
the old graph is dropped only after the new one is captured, so the pool
stays in use.  The capture is ``CUDAGraph.capture_begin`` /
``capture_end`` on a side stream that waits on the current one, not the
``torch.cuda.graph`` context manager, whose entry synchronizes the device,
collects garbage and empties the allocator's cache: at the serving batch
that would drain the pipeline every batch and hand back tens of GB for the
next prefill to map again.

Eager, by what the code can observe:
  * CPU tensors: there is no graph to capture;
  * a tensor-parallel model: the step all-reduces over gloo, which cannot
    be captured;
  * autograd on: the graph's tensors would be saved for a backward;
  * a capture already running on the current stream (the caller's own
    graph): the body joins it.
Every cache kind the step takes (int8/int4 lane, packed, float, grouped
query heads, rudalle_relax's masked statistics on the float cache, the
hybrid block's conv states beside its lane caches) launches from device
values alone, so none of them falls back.

Counters, in the kernel wrappers' idiom (``.launches``), over every
model: ``DecodeGraph.captures``, ``.replays`` and ``.eager`` (steps run
without a graph).  A kernel wrapper's ``.launches`` counts a captured
step's launches once, at the capture, and nothing at a replay.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _key(img_token: torch.Tensor, caches) -> tuple:
    """What a graph bakes in of the step's token and states."""
    return (img_token.shape, img_token.dtype, img_token.device,
            tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                  for state in caches for t in state.tensors()))


class DecodeGraph:
    """One model's decode-step graph: its position tensor, side stream,
    memory pool, and the graph with its static token and logits."""

    captures = 0
    replays = 0
    eager = 0

    def __init__(self):
        self.pos: Optional[torch.Tensor] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.warm = False         # a step has run on ``stream``
        self.pool = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key: Optional[tuple] = None
        self.tok: Optional[torch.Tensor] = None
        self.out: Optional[torch.Tensor] = None

    def __reduce__(self):
        # a copied or pickled model captures its own graph
        return DecodeGraph, ()

    def _position(self, device: torch.device, step: int) -> torch.Tensor:
        """The persistent step tensor on ``device``, set to ``step``.  Made
        outside inference mode, so that calls under ``no_grad`` may write
        it too."""
        pos = self.pos
        if pos is None or pos.device != device:
            with torch.inference_mode(False):
                pos = torch.zeros(1, dtype=torch.int32, device=device)
            self.pos = pos
        pos.fill_(step)
        return pos

    def run(self, body: Callable, img_token: torch.Tensor, step: int,
            caches, sharded: bool) -> torch.Tensor:
        """``body(img_token, pos, caches)`` at image position ``step``:
        eagerly, or replayed from the graph (module docstring)."""
        pos = self._position(img_token.device, step)
        if (not img_token.is_cuda or sharded or torch.is_grad_enabled()
                or torch.cuda.is_current_stream_capturing()):
            DecodeGraph.eager += 1
            return body(img_token, pos, caches)
        if step == 0:
            DecodeGraph.eager += 1
            return self._on_side(img_token.device,
                                 lambda: body(img_token, pos, caches))
        key = _key(img_token, caches)
        if step == 1 or self.graph is None or key != self.key:
            self._capture(body, img_token, pos, caches, key)
        self.tok.copy_(img_token)
        self.graph.replay()
        DecodeGraph.replays += 1
        return self.out.clone()

    def _on_side(self, device: torch.device, fn: Callable):
        """``fn()`` on the side stream of ``device``, ordered after the
        current stream's work and before its next."""
        main = torch.cuda.current_stream(device)
        if self.stream is None or self.stream.device != main.device:
            self.stream, self.warm = torch.cuda.Stream(main.device), False
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        self.warm = True
        return out

    def _capture(self, body: Callable, img_token: torch.Tensor,
                 pos: torch.Tensor, caches, key: tuple) -> None:
        device = img_token.device
        if not self.warm or self.stream.device != device:
            # the first use of a stream sets up its library state (cuBLAS's
            # workspace), which must not come from the graph's pool; the
            # step writes the same k/v at the same position again (a
            # Mamba2 state would advance twice: step 0 warms the stream,
            # so a sampling run never comes here)
            DecodeGraph.eager += 1
            self._on_side(device, lambda: body(img_token, pos, caches))
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode(False):
            tok = torch.empty(img_token.shape, dtype=img_token.dtype,
                              device=device)
        graph = torch.cuda.CUDAGraph()

        def captured():
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out = body(tok, pos, caches)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the body's error is the one to report
                raise
            graph.capture_end()
            return out

        out = self._on_side(device, captured)
        self.graph, self.key, self.tok, self.out = graph, key, tok, out
        DecodeGraph.captures += 1
