"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``src/repro`` is the reference; this package mirrors its
layout (``api/``, ``core/``, ``ml/``, ``data/``, ``kernels/<name>/{kernel,
ops,ref}.py``) so each module's counterpart is found by path, and it
imports ``torch`` and numpy only — never ``jax``, never ``repro``.

Ported so far: ``api.fit`` on the local executor with ``GradientDescent`` /
``FunctionStrategy`` / ``ProxStrategy``, the ``allreduce`` / ``delay_line``
/ ``sequential_server`` / ``stale_server`` / ``admm_consensus`` transports, the ``dense`` /
``thresh`` / ``topk`` / ``int8`` wires (±ef), fault plans, and the four
wire-encode kernels (``kernels/topk_compress``, ``kernels/int8_quant``) as
hand-written CUDA (``csrc/wire_kernels.cu``); continuous-batching LM
serving (``serve``, ``models``) with decode attention in CUDA, split
over the keys and merged (``csrc/decode_attention.cu``); the §4 clustering family (``ml.clustering``,
``ml.kwindows``, consensus ADMM in ``core.admm``) with the nearest-centroid
E-step in CUDA (``csrc/pdist_argmin.cu``); the cache-free attention core
(``models.attention.attn_apply`` with ``use_kernel=True``, and
``_sdpa_q_chunked``) with flash attention in CUDA (bf16 on the tensor
cores, ``csrc/flash_attention_tc.cu``; f32 as 3xTF32 on the tensor cores,
``csrc/flash_attention_tf32.cu``), ``kernels.topk_compress.ops.topk_sparsify``
with its count and mask in CUDA (``csrc/topk_sparsify.cu``); and training
— ``api.OptimizerStrategy`` under ``delay_line`` × ``topk:f+ef`` with
``optim``, the LM loss (``models.transformer.loss_fn``), ``checkpoint``
in the JAX package's format, the LM token stream (``data``) and
``launch.train``; the executors beyond local (``sweep``, ``mesh``,
``multipod``); request/response serving (``serve.ServeEngine``,
``MicroBatcher``, ``ModelRegistry``, the ``serve`` executor and
``launch.serve``'s microbatched and fit → publish → serve paths), the
run timeline (``telemetry``: ``Tracer``, ``RunReport``, the
``trace="phases"`` probes), and the MLA, MoE and multi-token-prediction
models (``models.mla``, ``models.moe``, ``transformer.mtp_hidden``:
minicpm3-4b, olmoe-1b-7b, deepseek-v3-671b).  Kernels are built with ``nvcc``
on first use.  What is not ported raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item.

Idiom: plain functions on tensors; dicts, tuples and NamedTuples for
pytrees (``torch.utils._pytree``); an explicit ``device`` (default
``"cuda"``; without a GPU, pass ``device="cpu"`` or the entry points
raise); explicit ``torch.Generator``s; a batch dimension written out (or
``torch.func.vmap``) where the reference vmaps; Python loops where it
scans.  The reference's ``jit``, its program cache (``cached_program``)
and the reprolint-driven trace hygiene have no counterpart: PyTorch runs
eagerly, so there is no trace to keep clean or to cache (``dispatch`` tags
every executor loop ``uncached``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
