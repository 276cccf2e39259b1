#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``tfk8s_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
must pass:

1. the card: ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles every kernel source of the port from the
   checkout (``tfk8s_tpu_torch/ops/_build.py``), timed, with the ptxas
   register and spill report of the tensor-core flash kernels and the
   one-read GroupNorm kernels (none may spill) and the block copy;
3. kernels: each kernel against its plain PyTorch version on the same
   card inputs, each with its time, the plain version's time, its bound
   and a one-call PyTorch yardstick (timed here only; the port never
   calls it):
   - flash attention: in bfloat16 the tensor-core forward, the D
     pre-pass, the tensor-core dq and dk/dv, and the whole backward
     (pre-pass + dq + dk/dv, as training runs it), at the GPT slice's
     shape, a ragged d=128 case and a masked d=32 case (atol 2e-2 + rtol
     2^-7; D and lse * log2(e) atol 1e-5); in float32 the CUDA-core
     forward, dq and dk/dv on small cases (a key mask with a fully masked
     row, causal with lq < lk, ragged lengths; atol 1e-5 outputs, 1e-4
     gradients); the slice's FLOPs at d=128 with half the heads; each with
     its achieved TFLOP/s; yardstick ``scaled_dot_product_attention``
     (its backward for dq, dk/dv and the whole backward: no PyTorch call
     computes dq alone); at the slice's shape also each row's device time
     and its yardstick's from a ``torch.profiler`` trace, which leave out
     the host time that CUDA events over back-to-back calls of a short
     kernel or of an autograd call include;
   - GroupNorm forward and backward, float32 and bfloat16, through the
     one-read kernels at the two largest ResNet-50 norm sites
     [256,112,112,64] (ReLU) and [256,56,56,256], the widest
     [256,7,7,2048] (ReLU) and ResNet-50 at width 128's [64,7,7,4096]
     (ReLU), and through the two-read kernels at [16,256,256,32] in one
     group, each launch counted under the path the layout rule gives it;
     float32 atol 1e-5 outputs, 1e-4 dx, bfloat16 atol 2e-2 + rtol 2^-7,
     dscale and dbias atol 1e-2 + rtol 1e-3; device times from the
     profiler beside CUDA-event times; yardstick ``F.group_norm`` (+
     ``relu``) on the channels-last NCHW view and its autograd backward;
     then every ResNet-50 norm site's shape once
     (``tfk8s_tpu_torch/tools/gn_sweep.py``), for the per-step GroupNorm
     device and event times against the bounds;
   - the block copy at [8192, 8192] float32, bit-exact; yardstick
     ``Tensor.copy_``;
4. reference: a small float32 GPT on the card through the kernels
   against the same model on the CPU through the plain versions (loss
   and every gradient to atol 1e-4), and the base-width bfloat16 model's
   forward and backward through the kernels against plain attention:
   loss atol 2e-2, the key/value projections' gradients within
   BASE_GRAD_REL_L2 relative L2 and the query projection's within
   BASE_Q_GRAD_REL_L2, bounds that a planted dk/dv fault and a planted dq
   fault (D taken as zero) must exceed;
5. resnet reference: a small float32 ResNet-50 (width 8) on the card
   through the GroupNorm kernels against the same model on the CPU through
   the plain versions (loss atol 1e-4, gradients 1e-3 relative L2; every
   one of the 53 norms through the one-read kernels), and
   ResNet-50 at full width on one input, kernel GroupNorm against plain
   GroupNorm: in float32, logits within 1e-4 of the largest logit; in
   bfloat16 within 2%, where a sound variant of the plain GroupNorm must
   pass that bound and planted faults must fail it;
6. train: ``tfk8s_tpu_torch.models.gpt.train(env)``, the ``gpt:train``
   entrypoint, at the GPT-2-small base preset (seq 1024, batch 8,
   ``TFK8S_ATTENTION_IMPL=flash``) for a few steps with a checkpoint:
   finite losses, the tensor-core forward, D pre-pass, dq and dk/dv each
   launched 12 times a step and the CUDA-core float32 kernels never, the
   checkpoint committed at the last step;
7. resnet train: ``tfk8s_tpu_torch.models.resnet.train(env)``, the
   ``resnet:train`` entrypoint, at ResNet-50 (depth 50, width 64, batch
   256, image 224, 1000 classes, bfloat16) for a few steps with a
   checkpoint: finite losses, each one-read GroupNorm kernel launched 53
   times a step and the two-read kernels never, the checkpoint
   committed; step time, images/s, first step, peak memory, input wait
   and input-starved steps;
8. roofline: ``tfk8s_tpu_torch.tools.roofline.run_all()`` at full size
   (matmul, streams, the block-copy kernel, ResNet-50 forward, GN-ablated
   step and full step), one JSON line; the copy kernel must launch;
9. generate: ``gpt.generate`` and ``gpt.beam_generate`` at GPT-2-small
   base width in bfloat16 with ``attention_impl="flash"`` (random weights
   from seed 0): greedy on batch 8, prompt 512, 64 generated, whose
   prefill must launch the tensor-core flash forward 12 times (prefill
   time, per-token decode time and device-idle share from a profiler
   trace, tokens/s, peak memory); sampled (temperature 0.8, top_k 50,
   top_p 0.95, one key) must repeat itself under the same key and equal
   greedy at top_k 1; an ``eos_id`` the greedy stream emits mid-way must
   stop and pad every row; 4 beams on batch 2 (prompt 256, 32 tokens),
   one beam equal to greedy. In float32 (TF32 off) the greedy tokens of
   4 rows must be the full forward's argmax at every position and the
   paged decode loop's tokens, but at float32 ties (1e-4). The bf16
   prefill logits, flash against plain attention, must lie within
   GENERATE_LOGIT_REL_L2 relative L2, which the flash kernel called
   non-causal must exceed. Then the flash forward at the prefill's shape
   [8, 512, 12, 64] against its plain version and SDPA, with device times;
10. serve: ``tfk8s_tpu_torch.runtime.server.serve(env, stop)``, the
   TPUServe entrypoint, in-process at GPT-2-small base width in bfloat16
   (8 slots, 16-token pages, 513 pages): 24 requests with prompts of
   16-512 tokens and 64 generated each, a third sampled (temperature
   0.8, top_k 50, top_p 0.95, fixed seeds), a third sharing a 256-token
   prefix. Every request must complete with 64 tokens; each sampled
   request, run again alone, must give the same stream; no kernel of the
   port may launch (the paged path is torch ops, as the reference's is
   jnp). In float32 with TF32 off, 4 greedy requests through the same
   decoder must emit at every position the argmax of the non-paged full
   forward over the sequence so far. It prints time to first token (p50,
   p99), mean time per output token, output tokens/s, peak memory, and
   one decode step's time, device time and device-idle share from a
   ``torch.profiler`` trace, greedy and sampled. Then 24 greedy requests
   of three bucket lengths (128, 256, 512; 64 generated) through the same
   decode loop and through the slot-per-batch executor
   (``TFK8S_SERVE_DECODE_LOOP=0``, max batch 8), side by side: latency
   p50/p99, output tokens/s, peak memory; and ``echo`` and ``mlp``
   through ``server.serve``, a few requests each;
11. distributed: record-file input, a two-rank gang and the Evaluator at
   GPT-2-small base width (bfloat16, flash, seq 1024, random weights from
   seed 0). The port's ``RecordWriter`` writes four training shards and
   one evaluation shard of ``{"input": int32[1024]}`` chain-token rows
   through the native record core (which must load), with its write
   rate. ``gpt.train(env)`` trains 10 steps of batch 8 from the shards
   (``TFK8S_INPUT_FILES``) with a checkpoint: finite losses, each
   tensor-core flash kernel launched 12 times a step and the CUDA-core
   ones never, the first batch the trainer drew equal by hash to the
   dataset's first batch read on the host, the final checkpoint
   committed; step time, tokens/s, input wait and starved steps. Then two
   processes join a gloo process group (``TFK8S_DISTRIBUTED=1``; NCCL will
   not put two ranks on one card) and train ``data=2`` with per-host
   input, global batch 8, 4 steps, a checkpoint at step 4, each bounded by
   a timeout, at GANG_LAYERS layers as every one-card gloo gang of phases
   11-18 (and the one-process runs they are held to): the published
   widths, head counts, sequence lengths and batches, the depth cut; their
   shard hashes equal a one-process run's in this
   process, their losses are identical and within DIST_LOSS_ATOL of the
   one-process run's, their final parameter checksums are equal exactly.
   One process then resumes the gang's checkpoint with
   ``TFK8S_WORLD_VERSION=1`` to step 6, within DIST_LOSS_ATOL of the
   uninterrupted 6-step run. Last, ``run_eval`` scores the 10-step run's
   checkpoint on the evaluation shard: finite metrics, the loss within
   DIST_LOSS_ATOL of the same parameters and batches through plain
   attention, the flash forward launched 12 times a batch; eval seconds;
12. families: the BERT MLM, ViT and T5 families at their published widths
   (bf16 activations, f32 parameters, ``TFK8S_ATTENTION_IMPL=flash``,
   random weights from seed 0; only the steps cut): ``bert:train``
   (BERT-base, seq 512, batch 32, 10 steps), ``vit:train`` (ViT-B/16,
   224/16 so 196 tokens, 1000 classes, batch 64, 6 steps) and ``t5:train``
   (T5-base, seq 512, batch 16, 10 steps): finite losses, each tensor-core
   flash kernel launched sites x steps times (12, 12 and 36 sites a step)
   and the CUDA-core ones never; step ms, tokens or images a second,
   first step, peak memory, input wait; then the same step on batches
   staged on the card, with one step's profiler trace (busy time, idle
   share, the leading kernels, the ``[b, l]`` ``_to_copy`` calls that
   count T5's mask conversions). Each family, flash against plain
   attention on one base-width batch (T5 also on one whose sources end in
   PAD_ID tails): loss within BF16_ATOL and every gradient within
   FAMILY_GRAD_REL_L2, which BERT's kernel called causal and T5's with
   its mask dropped on the padded batch must exceed; a small float32
   config (TF32 off) through the kernels against the CPU plain path, loss
   and gradients within F32_GRAD_ATOL. Then ``t5.greedy_generate`` at
   T5-base width on 8 sources of 512 tokens, 64 generated: 12 launches of
   the flash forward (the encoder's) and no other kernel; encoder ms,
   per-token ms and the device-idle share of a token; a sampled stream
   repeats under its key. Last, the flash kernels at each family's
   training call (BERT [32, 512], ViT [64, 196], T5 [16, 512] with
   padded keys; 12 heads of 64) against their plain versions and SDPA,
   with device times;
13. parallel: the sequence and expert axes. (a) ``gpt:train`` with
   ``TFK8S_NUM_EXPERTS=8`` at GPT-2-small width (6 MoE layers, top-1,
   capacity 1.25; seq 1024, batch 8, bf16, flash, 10 steps): finite losses
   and ``moe_aux``, 12 launches a step of each tensor-core flash kernel;
   each step's ms, tokens/s, ``moe_aux`` and peak memory; two steps at
   ``TFK8S_MOE_TOP_K=2``; the ten steps again in float32 (plain
   attention), each step's loss and ``moe_aux``; one profiler trace of the staged step split into
   the float32 dispatch and combine products, the expert FFN, the float32
   head, flash, AdamW and the rest, beside the FLOPs those products need;
   the staged step's time and idle share. (b) identical experts with ample
   capacity against the gate-weighted dense MLP at base width (bf16
   bounds); a small float32 MoE GPT through the kernels against the CPU
   plain path (F32_GRAD_ATOL); ``remat`` against none at (a)'s
   configuration, loss and gradients within F32_GRAD_ATOL, with both peak
   memories; the flash kernels at Ulysses' local call ([8, 512, 6, 64],
   non-causal and causal, bf16 and f32) against their plain versions. (c)
   which collectives gloo takes CUDA tensors for (each in a fresh pair of
   processes); then two-rank gloo gangs sharing the card in one launch,
   each running its family's ``train(env)`` for two steps (a planted
   fault's one) with ``TFK8S_MESH`` set, its
   first update's gradient (read by an optimizer pre-hook) and loss
   against one process's run of the same entry point with flash attention
   (loss within PARALLEL_LOSS_ATOL, every gradient within
   FAMILY_GRAD_REL_L2 relative L2): BERT-base at seq 512 on ``{"sequence":
   2}`` through Ulysses (the policy's choice, the flash kernels inside:
   every rank launches each tensor-core kernel layers x steps times) and
   through ring attention (no flash launch), GPT-2-small through ring, and
   GPT-2-small through a ring whose causal mask drops the blocks' global
   offset, which must exceed the bounds. (d) GPT-2-small + 8 experts on
   ``{"expert": 2}``. Each gang prints its ranks' step time, launches and
   the collectives gloo staged through host memory;
14. tensor: the tensor axis. The flash kernels at a tensor rank's calls
   (6 of 12 heads: GPT-2-small's causal [8, 1024, 6, 64], BERT-base's
   [32, 512, 6, 64], T5-base's key-masked [16, 512, 6, 64], ViT-B/16's
   ragged [64, 196, 6, 64]) against their plain versions and SDPA, with
   device times. Then two-rank gloo gangs sharing the card on ``{"tensor": 2}``
   in one launch, each running its family's ``train(env)`` for two steps (a
   planted fault's one) at full width
   (GPT-2-small seq 1024 batch 8, BERT-base seq 512 batch 8, T5-base seq
   512 batch 8, ViT-B/16 224/16 batch 16; bf16, flash), its first
   update's gradient and loss against one process's run of the same entry
   point (PARALLEL_LOSS_ATOL, FAMILY_GRAD_REL_L2), every rank launching
   each tensor-core kernel layers x steps times (T5: three sites a layer)
   with every forward at 6 heads; GPT-2-small with every row split left unsummed must exceed the
   bounds. Then ``dlrm:train`` at its defaults (eight tables of 100,000 x
   64, batch 4,096, bf16 compute) for 20 steps in one process, whose loss
   must fall and which launches no flash kernel, and its ``{"tensor": 2}``
   gang (a run of the same launch)'s first update against it (the whole
   gradient's relative L2, and
   each table's own: the tables hold too little of the norm to show in
   the whole). Each gang prints its ranks' step time
   beside one process's: two gloo ranks on one card measure gloo, not
   scaling;
15. axes: the combined model axes. The flash kernels at the new calls
   (Ulysses beside tensor at BERT-base's [8, 512, 3, 64], 12 heads over
   tensor 2 and sequence 2, bf16; a ``{"tensor": 2}`` rank's generate
   prefill at GPT-2-small's causal [8, 512, 6, 64], bf16 and f32) against
   their plain versions and SDPA, with device times. Then four-rank gloo
   gangs sharing the card, each running its family's ``train(env)`` for
   two steps with ``TFK8S_MESH`` set, its first update's whole gradient
   (the fsdp, expert and tensor shards gathered on rank 0) and loss
   against one process's run of the same entry point with flash
   (PARALLEL_LOSS_ATOL, FAMILY_GRAD_REL_L2): (a) GPT-2-small (seq 1024,
   batch 8) on ``{"fsdp": 2, "tensor": 2}``; (b) GPT-2-small + 8 experts
   on ``{"expert": 2, "tensor": 2}`` (each expert's hidden width split),
   and the same with each expert's ``wo`` block left unsummed over tensor,
   which must exceed the bounds; (c) BERT-base (seq 512, batch 8) on
   ``{"sequence": 2, "tensor": 2}`` through the policy (Ulysses, flash
   inside at 3 heads), and the same with Ulysses' exchange back putting
   the head blocks in reverse order, which must exceed the bounds; (d)
   the MoE GPT on ``{"fsdp": 2, "expert": 2}``; (e) BERT-base on
   ``{"fsdp": 2, "sequence": 2}``. Every rank launches each tensor-core
   kernel layers x steps times, every forward at the heads its layout
   gives; each gang prints its ranks' step time and peak memory beside
   one process's step. Then ``gpt.greedy_generate`` at GPT-2-small width,
   8 prompts of 512, 32 tokens, on a ``{"tensor": 2}`` gang: in float32
   the tokens equal one process's but at near ties (GENERATE_F32_TIE_ATOL,
   against the one process's full forward), in bfloat16 the share of
   equal tokens is printed; each rank's prefill launches the flash forward
   once a layer at 6 heads;
16. nccl: with two cards or more GPT-2-small as one pod of a card a rank
   at full depth, started by ``gpt:train``'s first act over NCCL, on
   ``{"data": 2}`` (DDP) and ``{"fsdp": 2}`` (FSDP2), and with four cards
   on ``{"data": 2, "fsdp": 2}`` (HSDP) and ``{"fsdp": 4}``, each against
   one process at the gang bounds (first loss atol 2e-2, the first
   update's whole gradient within 5e-2 relative L2) with every rank's
   flash launches 12 a step; the gangs of phase 13 (but the
   planted fault) run again over NCCL, a card a rank, against one
   process, and so does the pipelined BERT-MLM of phase 17 on
   ``{"pipeline": 2}``; with four cards T5-base on ``{"data": 2, "tensor":
   2}`` (``BASELINE.json`` configs[3]), GPT-2-small on ``{"tensor": 4}`` (3
   heads a rank), the combined-axes gangs (a)-(c) of phase 15, and the
   pipelined BERT-MLM on the reference's ``{"pipeline": 2, "data": 2}``
   and on ``{"pipeline": 4}`` (3 layers a stage), and gangs (a) and (d)
   of phase 18, all at full depth, and an ``h100-4`` TPUJob through the
   port's operator (phase 24): one pod requesting ``nvidia.com/gpu: "4"``
   whose entry point runs GPT-2-small on ``{"data": 4}`` as four NCCL
   ranks, a card each; with fewer cards, a line says what was skipped and
   why;
17. pipeline: ``tfk8s_tpu_torch.models.pipelined.train(env)``, the
   ``pipelined:train`` entrypoint (GPipe over the ``pipeline`` axis), at
   BERT-base width (12 layers, 768 wide, 12 heads, vocab 30,522, bf16)
   with the reference's defaults (seq 128, batch 64, 4 microbatches): one
   process (one stage holding every layer) for 10 steps, finite losses,
   its step time and peak memory, and its step on batches staged on the
   card beside BERT's unpipelined stack on the same batch, each with a
   profiler trace (busy time, idle share, leading kernels); then two gloo
   ranks sharing the card on
   ``{"pipeline": 2}`` over two slices (``TFK8S_NUM_SLICES=2``: the stage
   send crosses the slice boundary), two steps at GANG_LAYERS layers (a
   layer a stage), their first update's loss and whole gradient (the
   stages' layers put together) against one process's at that depth
   (PARALLEL_LOSS_ATOL, FAMILY_GRAD_REL_L2), which a planted fault (the
   last stage records microbatch t - s - 1 for t - s; one step, in the
   same launch) must exceed; each rank's step time beside the one
   process's, the collectives
   gloo staged through host memory and peak memory. The stages run plain
   attention, as the reference's do: no kernel of the port may launch on
   any rank, flash or GroupNorm;
18. pipeline_axes: the pipeline axis beside the other axes at full
   width, four-rank gloo gangs sharing the card in one launch, each
   through its entry point for two steps with ``TFK8S_MESH`` set, its
   first update's whole gradient (``DataParallel.whole_grads``: blocks,
   shards and stages gathered on rank 0) and loss against one process's
   run of the same entry point (PARALLEL_LOSS_ATOL, FAMILY_GRAD_REL_L2):
   (a) ``pipelined:train`` at BERT-base width with the reference's
   defaults (seq 128, batch 64, 4 microbatches; GANG_LAYERS layers, as
   every gang here, the one-process runs shared with phases 15 and 17)
   on ``{"pipeline": 2,
   "tensor": 2}`` (each stage's layers split), and the same with every
   row split left unsummed, which must exceed the bounds; (b) the same on
   ``{"pipeline": 2, "fsdp": 2}``; (c) on ``{"pipeline": 2, "sequence":
   2}``, and the same with every sequence rank taking the whole
   sequence's loss as a replica (the reduction then counts the gradient
   twice), which must exceed them; (d) GPT-2-small (seq 1024, batch 8)
   on ``{"pipeline": 2, "tensor": 2}``, flash at 6 heads on every rank,
   each tensor-core kernel launched layers x steps times; (e)
   GPT-2-small + 8 experts on ``{"pipeline": 2, "expert": 2}``; (f)
   ``dlrm:train`` at its defaults on ``{"fsdp": 2, "tensor": 2}``, each
   table's gradient on its own too. The pipelined and DLRM ranks launch
   no kernel. With four cards phase 16 runs (a) and (d) over NCCL too.
19. disagg (run right after serve): the serving data plane across
   replicas, each a ``server.serve`` of SERVE_ENV (GPT-2-small, bfloat16,
   16-token pages) under its own pod name. (a) A prefill replica
   (``TFK8S_SERVE_PHASE=prefill``) and a decode replica (``decode``, its
   prefix cache off, so every handoff lands all its pages): each of the
   serve phase's 24 requests through ``submit_prefill``,
   ``LocalKVTransport`` and ``submit_handoff`` must give the decode
   replica's own colocated stream exactly (the prefill's token its first),
   and the same buffers with layer 0's K rows zeroed must change at least
   one stream; per request the wire bytes, the serialize-and-read ms, the
   wait to import, and the time to the first decode token (the same
   buffer handed over again for one decode step, one at a time) beside
   the colocated TTFT.
   (b) A host-tier replica at DISAGG["host_pages"] pages (one max_len
   request and the trash page) with 1 GiB of host KV: a 512-token prompt
   served, its pages demoted by other prompts, served again by a host
   restore to the same tokens; with its host entry corrupted it must
   count ``restore_failed`` and still give them by a plain prefill. (c)
   The prefill replica, peer fetch on, pulls that prefix from (b)'s
   replica (``kv_peer``): ``outcome="ok"``, the same tokens. (d) On the
   decode replica, 8 concurrent requests with one prompt poisoned: that
   row fails ``RowFault``, the other 7 equal a clean run's streams, its
   pages stay quarantined through another batch until verified; then
   ``server.chaos_crash_replica`` fails an in-flight request typed
   ``ReplicaUnavailable``, the replica reports not ready and its
   ``serve()`` ends with the crash's own message (not an error of the
   loop that the crash set off). No kernel of the port may launch, and
   the phase must end within DISAGG["limit_s"] seconds;
20. profile: ``gpt:train`` at phase 6's configuration (GPT-2-small, seq
   1024, batch 8, bf16, flash, 10 steps logged every step) with
   ``TFK8S_PROFILE_DIR``: one Chrome trace, whose ``ProfilerStep#4`` to
   ``#8`` spans (3 steps skipped, 5 traced) each launch every tensor-core
   flash kernel 12 times (a kernel belongs to the span that launched it).
   It prints each span's length, the union of its device activities
   (busy), the idle share, the window's host step time from the
   history's clock, and the step's device time by group (flash, GEMMs,
   optimizer, copies, the rest) and by its ten leading operations, each
   with its launches: the dense step's split. Then 8 steps logged every 4,
   once with ``TFK8S_SCAN_STEPS=4`` and once a step a dispatch: the two
   histories must be identical; their steps 5-8 give each run's
   unprofiled step time on the host's clock (runs other than the traced
   one, so no idle share is derived from them);
21. text: the port's corpus CLI (``python -m tfk8s_tpu_torch.data.corpus``)
   trains a byte-level BPE tokenizer of vocabulary 512 on ``README.md``,
   ``SURVEY.md`` and ``PAPER.md`` of the checkout and writes two shards
   of 1024-token rows; ``gpt:train`` at GPT-2-small width (TRAIN_ENV,
   ``TFK8S_VOCAB_SIZE`` the tokenizer's) trains 6 steps from the shards
   into ``gs://chip-smoke-text/gpt2-small/run`` under a
   ``TFK8S_GCS_FAKE_ROOT`` in ``build/``, is restarted
   (``TFK8S_GANG_RESTARTS=1``) and resumes to step 12: the loss falls, the
   checkpoint sits at ``<root>/<bucket>/<key>``, each tensor-core flash
   kernel launches 12 times a step, and a greedy continuation of the
   checkpoint's model in float32 (one flash forward a layer in its
   prefill) decodes to a non-empty string whose every token is the
   checkpoint's full-forward argmax (or within GENERATE_F32_TIE_ATOL of
   it);
22. images: image-record input (``TFK8S_INPUT_FORMAT=image``). It prints
   the host's decoders (PIL, the port's libjpeg core or the compiler's
   last line, the backend ``resolve_backend`` picks), then writes two
   shards of 512 image records through the port's ``write_image_shards``
   from eight 64x64 class JPEGs kept in this script, each stamped with
   its frame header's geometry. With a decoder, ``resnet:train`` at
   ResNet-50 width (configs[1]: batch 256, 224 px, 1000 classes) trains 4
   steps and ``vit:train`` at ViT-B/16 (batch 64) 2 steps from the shards:
   finite losses, 53 launches of each one-read GroupNorm kernel a step
   and 12 of each tensor-core flash kernel a step, the decoded images a
   second, input wait and starved steps. Without one (the card host has
   neither PIL nor libjpeg), ``resnet:train`` from the shards must raise
   ``ImageDecodeError`` naming Pillow before its first step (no GroupNorm
   launch), the same shards without ``TFK8S_INPUT_FORMAT`` must fail on
   their schema, and the refusal must come within IMAGES["refuse_limit_s"]
   seconds of the phase's start. Either way one fallback warning, naming
   the native core, is logged where the core did not build, none where
   it did.
23. pod_ranks: a pod whose mesh spans more devices than the job has
   processes, run as one rank process a device by the entry point's first
   act (``runtime/pod_ranks``), with ``TFK8S_NUM_PROCESSES=1``. (a)
   GPT-2-small (bf16, flash, GANG_LAYERS layers, seq 1024, batch 8) on
   ``{"data": 2}``: two gloo ranks sharing the card, whose losses and
   first update's whole gradient must equal bit for bit those of the same
   job run by two processes started by hand (the kept gloo pair of
   ``GangPool``), on the same per_host input; (b) T5-base on ``{"data": 2,
   "tensor": 2}`` (four ranks, GANG_LAYERS layers, seq 512, batch 8)
   against one process at the gang bounds (first loss atol 2e-2, the first
   update's whole gradient within 5e-2 relative L2); each rank of (a) and
   (b) launches every tensor-core flash kernel sites x layers x steps
   times; (c) the pod of (a) with local rank 1 raising at its first step:
   the entry point must raise naming that rank within
   POD["fault_limit_s"] seconds, and no rank process may be alive after.
   Each prints its wall time, spawn to first step, step time and every
   rank's peak memory. The entry point is ``chip_smoke.pod_entry``, a
   family's ``train`` at GANG_LAYERS depth with the families' first act
   (the depth cut patches the presets, so it must happen in each rank).
24. operator: the port's own control plane over the wire. ``python -m
   tfk8s_tpu_torch.cmd.main apiserver`` runs in a process of its own on a
   free port with a journal (``--journal-dir``) and writes a kubeconfig;
   where ``cryptography`` imports it serves HTTPS (``--self-signed``, one
   read-write token in ``--token-file``), else plain HTTP (a line says which,
   and the seconds to ``/healthz``). Two operators (``tfk8s_tpu_torch.
   cmd.server.Server`` with that kubeconfig, ``leader_elect`` as ``op-a``
   and ``op-b``, OPERATOR["lease_s"] leases, no local kubelet: a
   ``RemoteStore``, clientset, gang allocator, TPUJob controller behind the
   lease) and one standalone ``LocalKubelet`` on a clientset of its own run
   in this process with one ``h100-1`` host; op-a takes the lease first.
   Both jobs are sent with the port's verb, ``cmd.main.main(["submit",
   "--kubeconfig", ..., "--file", <the job as a JSON manifest>])``. (a)
   is held at its first finished update (an optimizer post-hook) while op-a
   stops gracefully (its stop event, then ``shutdown()``, which releases
   the lease): ``failover_s``, from that stop to op-b's ``elector.
   is_leader``, must be at most OPERATOR["failover_limit_s"]; every poll
   samples both electors, and before the stop only op-a may lead, after it
   only op-b, never both. Then the apiserver is killed with SIGKILL, (a)
   goes on, and the apiserver is started again on the same port from the
   same journal and certificates (the hand-over comes before the kill:
   both packages' electors end their threads on the outage's transport
   error, so none could hand over after it). Both jobs must end
   ``Succeeded`` with no restart, (a) must be running at the hand-over and
   the kill, and the restarted apiserver's resource_version must be at
   least the one read before the kill. Then, through ``main`` with its
   standard output captured: ``get`` (a table and ``-o json``: (a)
   ``Succeeded``), ``describe`` (listing (a)'s event reasons), ``logs
   --job`` (``==> default/<pod> (Succeeded) <==`` and a tail); and op-b's
   ``start_metrics_server(0)``: ``/healthz`` ``ok``, ``/metrics`` holding
   ``tpujob_succeeded_total`` at 2 or more, which only op-b's reconciles of (a) and
   (b) can have counted on op-b's registry (op-a stopped before (a) ended),
   and
   ``/events?key=default/<a>`` (a)'s events. It prints the start and
   restart seconds (to ``/healthz``, to the apiserver's own "listening"
   line, and its imports under ``-X importtime``), the outage (kill to
   ``/healthz``), the informers' relists, ``failover_s`` and the verbs'
   and the endpoint's replies. (a)
   ``manifests/examples/gpt-h100-torch.json``'s TPUJob, loaded with the
   port's ``load_manifest``: GPT-2-small (bf16, flash, 12 layers, seq
   1024, batch 8), 6 steps, must reach ``Succeeded`` with a pod requesting
   ``nvidia.com/gpu: "1"`` whose status carries its training progress and
   with 12 launches a step of every tensor-core flash kernel; (b) a second
   ``h100-1`` job at GANG_LAYERS depth (``pod_entry``), submitted once (a)
   runs, must be gang-pending with no pod until (a) ends (polled until the
   kill; after it, (b)'s pod must be no older than (a)'s completion time),
   start after (a) has ended and succeed. The manifest's entry point resolves to
   ``gpt:train`` through a recorder the phase registers (the kubelet keeps
   no return value), which keeps its history, launches, wall time and peak
   memory. (a)'s losses are held to a direct ``gpt:train`` call on the
   pod's env in this process: identical, or within OPERATOR["loss_atol"].
   It prints the phase's seconds, each job's submission to first update,
   wall time (the hold at its first update included, and printed apart)
   and peak memory. Then, on op-b (``_operator_priority``), two more
   ``h100-1`` jobs sent with ``submit``, each ``pod_entry`` at GANG_LAYERS
   depth (GPT-2-small widths, seq 1024, batch 8, bf16, flash): (c)
   ``gpt-h100-low`` at ``scheduling.priority`` 1 with a checkpoint
   directory, ``TFK8S_CHECKPOINT_EVERY`` OPERATOR["ckpt_every"] and
   OPERATOR["low_steps"] steps, held at its OPERATOR["preempt_at"]th update
   (an optimizer post-hook) until its pod's stop signal is set; (d)
   ``gpt-h100-high`` at priority 10 for OPERATOR["high_steps"] steps,
   submitted while (c) is held. (d) must take the host and succeed, (c)'s
   pod end (its phase printed: ``deleted`` once gone from the store) with
   ``preemptions`` 1 and ``gang_restarts`` 0, ``Preempted`` on (c) and
   ``PreemptedOther`` on (d); (c) must come back rendered with
   ``TFK8S_GANG_RESTARTS=1`` and its first step be one past the checkpoint
   its last run ended at (not 0). Held again at its
   OPERATOR["suspend_after"]th update, (c) is parked by the ``suspend``
   verb (``Suspended``, no live pod, ``preemptions`` 2, ``JobSuspended``),
   then the ``resume`` verb brings it back (``TFK8S_GANG_RESTARTS=2``) from
   its checkpoint to ``Succeeded`` at its last step. Each run of (c) must
   start after its predecessor's entry point has ended (the port's kubelet
   holds a pod recreated under a live pod's name until that pod's thread
   ends, so the resumed run restores the final save). The first loss of
   each resumed run must lie within OPERATOR["loss_atol"] of a direct
   ``pod_entry`` call on its env from a copy of the checkpoint it found,
   and (c)'s and (d)'s flash launches must be GANG_LAYERS x the steps all
   their runs took. It prints (d)'s submission to (c)'s stop signal, to
   (c)'s pod's end and to (d)'s first update, each resume to (c)'s next
   first update, (d)'s entry after (c)'s preempted run ended, and every
   run's checkpoint step, steps, first loss and seconds. Then job (e),
   ``gpt-h100-lost`` (``node_loss_entry``: ``pod_entry`` at GANG_LAYERS
   depth, OPERATOR["lost_steps"] steps, a checkpoint every
   OPERATOR["ckpt_every"]), on node agents in processes of their own: the
   ``kubelet --name node-a`` and ``--name node-b`` verbs, each in a process
   whose runtime warms while (c) and (d) run (torch, the card's context and
   what a training pod's first update and save import), node-a with an
   OPERATOR["node_lease_s"] node lease renewed every
   OPERATOR["node_renew_s"] (``TFK8S_NODE_LEASE_DURATION_S``,
   ``TFK8S_NODE_LEASE_RENEW_S``). Once (c) and (d) have succeeded the
   phase's in-process kubelet stops, node-a joins (its kubelet starts) and
   (e) is sent with ``submit``, so its pod is node-a's (the entry point
   resolved by ``module:attr``); node-b joins once that pod runs. After
   its OPERATOR["lost_hold_at"]th update (e) waits with step k's data
   written and its marker absent (k the last checkpoint step before the
   hold; k - 2 committed), and node-a is killed with SIGKILL. The leader must record ``NodeLost`` once (its
   ``/metrics``: ``tpujob_node_lost_pods_total`` 1), restart the gang
   once, and (e) must run again on node-b from step k - 2, every step from
   k - 1 to its last, and succeed; nothing in the checkpoint directory may
   change between the kill and node-b's entry, and node-a's run must not
   end. The resumed run's first loss must lie within
   OPERATOR["loss_atol"] of a direct ``pod_entry`` call from a copy of
   that checkpoint, and its flash launches be GANG_LAYERS x its steps.
   It prints kill to ``NodeLost``, kill to the first resumed update, the
   steps lost, node-b's start (its joining to its first lease) and each
   node's warm-up.
25. gateway: the port's serving control plane and front door in this
   process: ``Server`` with one ``h100-1`` host and ``gateway_port`` set
   (the TPUServe controller, the local kubelet and ``GatewayServer`` over
   the port's replica table). ``manifests/examples/gpt-serve-h100-torch.
   json``'s TPUServe, loaded with ``load_manifest`` (task ``gpt``,
   ``seed:0``, 2 replicas of ``tfk8s_tpu_torch.runtime.server:serve`` at
   GPT-2-small base width in bf16, 32 generated, 8 slots, 513 pages of 16,
   surge 1, none unavailable): (a) both replicas Ready, the serve
   ``Available`` with 2 ready, each pod requesting ``nvidia.com/gpu:
   "1"``, each decoder on ``cuda:0``; (b) GATEWAY["requests"] of the serve
   phase's mixed requests through ``GatewayClient`` over HTTP,
   GATEWAY["concurrency"] at a time, after a warm-up request to each
   replica and a timing baseline of as many other such requests submitted
   directly (spread over both; neither set seen by the prefix caches),
   each reply token for token a direct ``submit`` of the same payload to
   a replica, and ``/debug/decode``
   listing both replicas; (c) ``spec.checkpoint`` patched to ``seed:1``
   while GATEWAY["roll_clients"] closed-loop clients send greedy requests
   through the gateway: no request may fail, on every poll at least 2
   replicas are Ready and at most 3 pods live, the old version's pods are
   deleted and 2 are updated; then a greedy request through the gateway
   equals a direct submit to a new replica and differs from the
   ``seed:0`` answer; (d) no kernel of the port launches, and the
   gateway's ``tfk8s_gateway_requests_total`` equals the requests sent.
   It prints submission to Ready, peak memory, replica-reported TTFT and
   client latency p50/p99 through the gateway beside the direct baseline, the
   rollout's seconds and the requests served during it. The phase fails
   above GATEWAY["limit_s"].

The launch counts are zeroed just before each path (phases 6-25) and
read just after it; the line's launches add up the paths'. Then it prints the card line, the ``kernels`` JSON
line and, last, the ``ok`` line. It exits non-zero, printing no result,
when a phase fails, when no card is visible, or when the port's package is
not beside it. ``--only PHASE[,PHASE]`` runs just those phases (and the
card and build) and prints no result: a development aid.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback

DEVICE = "cuda"
TRAIN_STEPS = 10
# the gpt:train run: GPT-2-small base preset, seq 1024, batch 8, flash
TRAIN_ENV = {
    "TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8", "TFK8S_ATTENTION_IMPL": "flash",
    "TFK8S_TRAIN_STEPS": str(TRAIN_STEPS), "TFK8S_LOG_EVERY": "1",
    "TFK8S_LEARNING_RATE": "3e-4", "TFK8S_SEED": "0",
}
SLICE = dict(b=8, l=1024, h=12, d=64)  # its attention: 12 heads of 64
BASE_CHECK = dict(preset="base_config", seq=1024, batch=2)  # bf16 reference check
# bf16 outputs: atol 2e-2 plus one bf16 rounding step (2^-7 of the value),
# since gradients reach magnitudes where one step exceeds 2e-2
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -7
F32_OUT_ATOL, F32_GRAD_ATOL = 1e-5, 1e-4
# H100 SXM peak FLOP/s by type (NVIDIA data sheet, dense); the memory
# rate and both timers are gn_sweep's (HBM_BYTES_PER_S, events_ms,
# device_ms), imported where they are used
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# bf16 base-width GPT, flash vs plain attention: the relative L2 distance
# of the key and value projections' gradients (they come from dk and dv
# alone). Measured 8.2e-3; a dk/dv with D = rowsum(dO * O) taken as zero
# measured 1.24 and must exceed the bound.
BASE_GRAD_REL_L2 = 5e-2
# the same for the query projection's gradients, which come from dq alone:
# measured 1.50e-2; a dq fed D = 0 measured 5.67 and must exceed the bound
BASE_Q_GRAD_REL_L2 = 5e-2
# kernel -> (source in the repo, the TPU kernel it replaces); the kernels
# of the GPT training path, which runs bfloat16
KERNEL_INFO = {
    "flash_fwd_wgmma": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                        "tfk8s_tpu/ops/flash_attention.py:149"),
    "flash_bwd_dq_wgmma": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                           "tfk8s_tpu/ops/flash_attention.py:233"),
    "flash_bwd_dsum": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                       "tfk8s_tpu/ops/flash_attention.py:317"),
    "flash_bwd_dkv_wgmma": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                            "tfk8s_tpu/ops/flash_attention.py:290"),
    "group_norm_fwd": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                       "tfk8s_tpu/ops/group_norm.py:68"),
    "group_norm_bwd": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                       "tfk8s_tpu/ops/group_norm.py:137"),
    # the two-read path, for shapes whose slab does not fit a cluster
    "group_norm_fwd_2pass": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                             "tfk8s_tpu/ops/group_norm.py:68"),
    "group_norm_bwd_2pass": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                             "tfk8s_tpu/ops/group_norm.py:137"),
    "block_copy": ("tfk8s_tpu_torch/ops/csrc/block_copy.cu", "tools/roofline.py:124"),
}
# the resnet:train run: ResNet-50 at its published widths
RESNET_STEPS = 6
RESNET_ENV = {
    "TFK8S_RESNET_DEPTH": "50", "TFK8S_RESNET_WIDTH": "64", "TFK8S_BATCH_SIZE": "256",
    "TFK8S_IMAGE_SIZE": "224", "TFK8S_NUM_CLASSES": "1000",
    "TFK8S_TRAIN_STEPS": str(RESNET_STEPS), "TFK8S_LOG_EVERY": "1",
    "TFK8S_LEARNING_RATE": "1e-3", "TFK8S_SEED": "0",
}
RESNET_GN_SITES = 53  # stem + 16 bottlenecks x 3 + 4 projections
# ResNet-50 at full width, kernel vs plain GroupNorm on one input, as a
# share of the largest logit. float32 (TF32 off): the two differ only in
# the order of float32 sums, so 1e-4. bfloat16: the two round the same
# float32 norm outputs to bfloat16 and may land one step apart; 50 layers
# whose residual branches carry random unit-scale norms amplify such flips
# (0.50-0.56% of the logit scale measured), so 2%. A sound variant of the
# plain GroupNorm (float64 statistics, 0.54%) must stay within the bound and
# planted faults must exceed it (statistics without a quarter of the
# positions 3.8%, channels in the wrong group 52%), so the bound sits
# between a sound reading and a faulty one. An eps or one-pass-variance
# fault (0.58-0.66%) is below bfloat16 noise here: the card tests hold those.
RESNET50_F32_LOGIT_RTOL = 1e-4
RESNET50_BF16_LOGIT_RTOL = 2e-2
RESNET50_FAULTS_CAUGHT = ("first_quarter_dropped", "groups_mismapped")
# GroupNorm cases: (name, [B, H, W, C], groups, relu); the line's shape
# first, for the one-read kernels; the last takes the two-read path (one
# group across a 256x256x32 image: 4 MB a sample in bfloat16, beyond 8
# blocks' shared memory) and gives the line its two-read rows
GN_CASES = [
    ("gn_56x56x256", (256, 56, 56, 256), 32, False),
    ("gn_112x112x64_relu", (256, 112, 112, 64), 32, True),
    ("gn_7x7x2048_relu", (256, 7, 7, 2048), 32, True),
    ("gn_7x7x4096_relu", (64, 7, 7, 4096), 32, True),  # ResNet-50 at width 128
    ("gn_256x256x32_g1", (16, 256, 256, 32), 1, False),
]
COPY_SHAPE = (8192, 8192)
# the serve run: GPT-2-small at base width, bf16, through serve(env, stop)
SERVE_ENV = {
    "TFK8S_SERVE_TASK": "gpt", "TFK8S_SERVE_CHECKPOINT": "seed:0",
    "TFK8S_SERVE_GPT_SIZE": "base", "TFK8S_SERVE_MAX_BATCH": "8",
    "TFK8S_SERVE_PAGE_SIZE": "16", "TFK8S_SERVE_MAX_PAGES": "513",
    "TFK8S_SERVE_GEN_TOKENS": "64", "TFK8S_POD_NAME": "chip-smoke-serve",
}
SERVE = dict(requests=24, gen=64, prompt_min=16, prompt_max=512, shared_prefix=256,
             f32_requests=4, profile_steps=10, timeout_s=600)
SERVE_SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
# the disagg run: SERVE's requests across a prefill and a decode replica,
# then a host-tier replica of 65 pages (64 of 16 tokens hold one
# 1,024-token request, and the trash page) and the poisoned batch
DISAGG = dict(fault_requests=8, host_prompt=512, host_gen=16, host_churn=3, host_pages=65,
              host_bytes=1 << 30, contain_requests=8, contain_gen=32, poisoned=3, seed=7,
              limit_s=60.0)
# the same 24 greedy requests through the decode loop and through the
# slot-per-batch executor (TFK8S_SERVE_DECODE_LOOP=0): prompts of three
# bucket lengths, 8 of each, 64 generated
LEGACY = dict(buckets=(128, 256, 512), per_bucket=8, gen=64, seed=3)
# the generate run: GPT-2-small at base width, bf16, flash prefill
GENERATE = dict(batch=8, prompt=512, gen=64, seed=5, key=1234, beam_batch=2,
                beam_prompt=256, beam_gen=32, beams=4, f32_rows=4)
# bf16 prefill logits, flash against plain attention, relative L2: the
# base-width GPT check's bound; a flash call made non-causal must exceed it
GENERATE_LOGIT_REL_L2 = 5e-2
# float32 generate vs the full forward (and the paged loop): the serve
# phase's tie rule
GENERATE_F32_TIE_ATOL = 1e-4
# the distributed phase: record shards of the GPT task at base width; the
# gang's global batch of 8 is 4 rows a rank
DIST = dict(train_files=4, records_per_file=32, eval_records=32, seed=11, gang_steps=4,
            resume_steps=6, eval_batches=4, timeout_s=300)
# bf16 base-width GPT losses across layouts (a gang against one process,
# a resume, flash against plain attention): the base-width check's loss
# bound
DIST_LOSS_ATOL = 2e-2
# float32 paged vs full forward: a position may pick another token than
# the full forward's argmax only where both logits are this close (a tie
# at float32 precision); every such position is counted and printed
SERVE_F32_TIE_ATOL = 1e-4
# the families phase: BERT-base MLM, ViT-B/16 and T5-base at their
# published widths (bf16 activations, f32 parameters, flash pinned, random
# weights from seed 0); only the steps are cut. ``sites`` is the flash
# call sites a step (T5: 12 encoder, 12 causal decoder, 12 cross)
FAMILY_ENV = {"TFK8S_ATTENTION_IMPL": "flash", "TFK8S_LOG_EVERY": "1", "TFK8S_SEED": "0"}
FAMILIES = {
    "bert": dict(env={"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "32",
                      "TFK8S_TRAIN_STEPS": "10", "TFK8S_LEARNING_RATE": "1e-4"},
                 sites=12, per_step=("tokens", 32 * 512)),
    "vit": dict(env={"TFK8S_IMAGE_SIZE": "224", "TFK8S_PATCH_SIZE": "16",
                     "TFK8S_NUM_CLASSES": "1000", "TFK8S_BATCH_SIZE": "64",
                     "TFK8S_TRAIN_STEPS": "6", "TFK8S_LEARNING_RATE": "1e-3"},
                sites=12, per_step=("images", 64)),
    "t5": dict(env={"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "16",
                    "TFK8S_TRAIN_STEPS": "10", "TFK8S_LEARNING_RATE": "1e-4"},
               sites=36, per_step=("tokens", 16 * 512)),
}
# flash against plain attention on one batch at base width (bf16): the
# base-width GPT check's bounds on the loss and on every parameter's
# gradient (relative L2); BERT's kernel called causal and T5's with the
# key mask dropped (on a batch whose sources end in PAD_ID tails) must
# exceed them
FAMILY_CHECK = dict(batch=4, vit_batch=8, seed=21, staged_steps=5)
FAMILY_GRAD_REL_L2 = 5e-2
# T5 greedy generation: 8 sources of 512 tokens, 64 generated
T5_GENERATE = dict(batch=8, src=512, gen=64, seed=23, key=99)
# the flash kernels at each family's training call, 12 heads of 64, bf16:
# (name, batch, length, key lengths); T5's keys up to 37% padded
FAMILY_KERNEL_CASES = [
    ("bert_bf16_non_causal", 32, 512, None),
    ("vit_b16_bf16_ragged_196", 64, 196, None),
    ("t5_bf16_key_mask", 16, 512, [512 - (i * 13) % 192 for i in range(16)]),
]


def log(msg: str) -> None:
    print(msg, flush=True)


class Case:
    """One attention problem on the card: inputs, visibility, and the
    work each kernel must do on them."""

    def __init__(self, name, b, lq, lk, h, d, dtype, causal=False, lengths=None, seed=0):
        import torch

        self.name, self.causal = name, causal
        self.dtype_name = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=DEVICE).manual_seed(seed)

        def normal(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

        self.q = (normal(b, lq, h, d).float() / math.sqrt(d)).to(dtype)  # pre-scaled
        self.k, self.v, self.do = normal(b, lk, h, d), normal(b, lk, h, d), normal(b, lq, h, d)
        self.mask = None
        if lengths is not None:
            pos = torch.arange(lk, device=DEVICE)
            self.mask = pos[None, :] < torch.tensor(lengths, device=DEVICE)[:, None]
        vis = torch.ones(lq, lk, dtype=torch.bool, device=DEVICE)
        if causal:
            vis = vis.tril(lk - lq)
        vis = vis[None, None].expand(b, 1, lq, lk)
        if self.mask is not None:
            vis = vis & self.mask[:, None, None, :]
        self.visible = vis  # [b, 1, lq, lk], for the library yardstick
        # (query, key) pairs this data needs, per head
        self.pairs = int(vis.sum().item()) * h
        self.elt = self.q.element_size()
        self.n_q, self.n_k = b * lq * h * d, b * lk * h * d
        self.n_lse = b * h * lq
        from tfk8s_tpu_torch.ops.flash_attention import DSUM_PAD

        self.n_pad = b * h * (-(-lq // DSUM_PAD) * DSUM_PAD)  # the D pre-pass's padded rows
        self.d = d

    def work(self, kernel: str):
        """(bytes, FLOPs) the kernel's function needs on these inputs:
        each input read once, each output written once."""
        e, qn, kn, lse, pad = self.elt, self.n_q, self.n_k, 4 * self.n_lse, 4 * self.n_pad
        if kernel.startswith("flash_fwd"):
            return e * (qn + 2 * kn + qn) + lse, 4 * self.pairs * self.d  # q k v in; o lse out
        if kernel == "flash_bwd_dq_wgmma":
            # q k v do, D and lse2 from the pre-pass in; dq out; QK^T, dO V^T, dS K
            return e * (2 * qn + 2 * kn + qn) + 2 * pad, 6 * self.pairs * self.d
        if kernel == "flash_bwd_dq_simt":  # reads o and lse itself
            return e * (qn + 2 * kn + 2 * qn + qn) + lse, 6 * self.pairs * self.d
        if kernel == "flash_bwd":
            # the whole backward: q do o, k v, lse in; dq, dk dv out; the
            # five products QK^T, dO V^T, P^T dO, dS K, dS^T Q
            return e * (4 * qn + 4 * kn) + lse, 10 * self.pairs * self.d
        if kernel == "flash_bwd_dsum":
            return e * 2 * qn + lse + 2 * pad, 2 * qn  # do o lse in; D, lse2 out
        if kernel == "flash_bwd_dkv_wgmma":
            # q k v do, D and lse2 from the pre-pass in; dk dv out
            return e * (2 * qn + 4 * kn) + 2 * pad, 8 * self.pairs * self.d
        # the CUDA-core dk/dv reads o and lse itself
        return e * (qn + 2 * kn + 2 * qn + 2 * kn) + lse, 8 * self.pairs * self.d

    def bound_ms(self, kernel: str):
        """Least time on the card: the larger of bytes over the memory
        rate and FLOPs over the peak rate for the inputs' type."""
        from tfk8s_tpu_torch.tools.gn_sweep import HBM_BYTES_PER_S

        nbytes, flops = self.work(kernel)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[self.dtype_name] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _library(case: Case):
    """``scaled_dot_product_attention`` on the same problem, [b, h, l, d]
    (the transposes are made once, outside the timed calls)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_() for t in (case.q, case.k, case.v))
    do = case.do.transpose(1, 2).contiguous()
    dense = case.mask is None and (not case.causal or q.shape[2] == k.shape[2])
    kw = dict(is_causal=case.causal) if dense else dict(attn_mask=case.visible)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, scale=1.0, **kw)

    out = F.scaled_dot_product_attention(q, k, v, scale=1.0, **kw)

    def bwd():
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    return fwd, bwd


def _err(pairs, atol, rtol=0.0):
    """(max |kernel - plain|, whether every element is within
    atol + rtol * |plain|)"""
    worst, ok = 0.0, True
    for a, b in pairs:
        diff = (a.float() - b.float()).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= atol + rtol * b.float().abs()).all())
    return worst, ok


def check_case(fa, case: Case, iters: int, profile: bool = False):
    """Each kernel against its plain version on ``case``; returns one
    result dict per kernel and, in bfloat16, one for the whole backward
    (pre-pass, dq and dk/dv against SDPA's backward). bfloat16 runs the
    tensor-core kernels, float32 the CUDA-core ones. ``profile`` adds each
    row's device time from a profiler trace."""
    import torch

    from tfk8s_tpu_torch.tools.gn_sweep import device_ms, events_ms

    bf16 = case.dtype_name == "bfloat16"
    out_tol = BF16_ATOL if bf16 else F32_OUT_ATOL
    grad_tol = BF16_ATOL if bf16 else F32_GRAD_ATOL
    rtol = BF16_RTOL if bf16 else 0.0
    q, k, v, do, mask, causal = case.q, case.k, case.v, case.do, case.mask, case.causal
    fwd, dq, dkv = (("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma") if bf16
                    else ("flash_fwd_simt", "flash_bwd_dq_simt", "flash_bwd_dkv_simt"))

    fa.reset_launches()
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, mask, causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, mask, causal)
    # the backward as training runs it: in bfloat16 one pre-pass feeds dq and dk/dv
    dq_k, dk_k, dv_k = fa.flash_bwd_cuda(q, k, v, do, o_k, lse_k, mask, causal)
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, do, o_k, lse_k, mask, causal)
    torch.cuda.synchronize()
    want = {fwd: 1, dq: 1, dkv: 1, "flash_bwd_dsum": int(bf16)}
    if dict(fa.LAUNCHES) != {**dict.fromkeys(fa.KERNELS, 0), **want}:
        raise AssertionError(f"{case.name}: launches {dict(fa.LAUNCHES)}, want {want}")

    live = lse_p > -1e29
    errs = {
        fwd: _err([(o_k, o_p), (lse_k[live], lse_p[live])], out_tol, rtol),
        dq: _err([(dq_k, dq_p)], grad_tol, rtol),
        dkv: _err([(dk_k, dk_p), (dv_k, dv_p)], grad_tol, rtol),
    }
    tols = {fwd: out_tol, dq: grad_tol, dkv: grad_tol}
    if not torch.equal(lse_k > -1e29, live):
        raise AssertionError(f"{case.name}: the kernel's fully masked rows differ")
    for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{case.name}: kernel {name} is not finite")
    if mask is not None and (~mask).all(dim=1).any():
        dead = (~mask).all(dim=1)
        for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
            if t[dead].abs().max() != 0:
                raise AssertionError(f"{case.name}: fully masked row gives nonzero {name}")

    lib_fwd, lib_bwd = _library(case)
    runs = {
        fwd: (lambda: fa.flash_fwd_cuda(q, k, v, mask, causal),
              lambda: fa.flash_fwd_plain(q, k, v, mask, causal), lib_fwd),
    }

    def dq_plain():
        return fa.flash_bwd_dq_plain(q, k, v, do, o_k, lse_k, mask, causal)

    def dkv_plain():
        return fa.flash_bwd_dkv_plain(q, k, v, do, o_k, lse_k, mask, causal)

    if bf16:
        # the pre-pass, dq and dk/dv, each alone, then the whole backward
        ds_k, l2_k = fa.flash_bwd_dsum_cuda(do, o_k, lse_k)
        ds_p, l2_p = fa.flash_bwd_dsum_plain(do, o_k, lse_k)
        torch.cuda.synchronize()
        fin = torch.isfinite(l2_p)
        errs["flash_bwd_dsum"] = _err([(ds_k, ds_p), (l2_k[fin], l2_p[fin])], F32_OUT_ATOL, 1e-6)
        if not torch.equal(torch.isfinite(l2_k), fin):
            errs["flash_bwd_dsum"] = (float("inf"), False)
        tols["flash_bwd_dsum"] = F32_OUT_ATOL
        runs["flash_bwd_dsum"] = (lambda: fa.flash_bwd_dsum_cuda(do, o_k, lse_k),
                                  lambda: fa.flash_bwd_dsum_plain(do, o_k, lse_k), None)
        runs[dq] = (lambda: fa.flash_bwd_dq_wgmma_cuda(q, k, v, do, ds_k, l2_k, mask, causal),
                    dq_plain, lib_bwd)
        runs[dkv] = (lambda: fa.flash_bwd_dkv_wgmma_cuda(q, k, v, do, ds_k, l2_k, mask, causal),
                     dkv_plain, lib_bwd)
        errs["flash_bwd"] = (max(errs[dq][0], errs[dkv][0]), errs[dq][1] and errs[dkv][1])
        tols["flash_bwd"] = grad_tol
        runs["flash_bwd"] = (lambda: fa.flash_bwd_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                             lambda: fa.flash_bwd_plain(q, k, v, do, o_k, lse_k, mask, causal),
                             lib_bwd)
    else:
        runs[dq] = (lambda: fa.flash_bwd_dq_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                    dq_plain, lib_bwd)
        runs[dkv] = (lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                     dkv_plain, lib_bwd)
    results = []
    for name, (kern, plain, lib) in runs.items():
        bound, by = case.bound_ms(name)
        ms = events_ms(kern, iters)
        r = {
            "case": case.name, "kernel": name, "dtype": case.dtype_name,
            "max_abs_err": errs[name][0], "atol": tols[name], "rtol": rtol,
            "ms": ms, "plain_ms": events_ms(plain, max(iters // 4, 1)),
            "bound_ms": bound, "bound_by": by, "tflops": case.work(name)[1] / ms * 1e-9,
            "library_ms": None if lib is None else events_ms(lib, iters),
        }
        if profile:
            r["device_ms"] = device_ms(kern, iters)
            r["library_device_ms"] = None if lib is None else device_ms(lib, iters)
        log(f"  {json.dumps(r)}")
        if not errs[name][1]:
            raise AssertionError(f"{case.name}/{name}: beyond atol {tols[name]} rtol {rtol}")
        results.append(r)
    return results


def _gn_inputs(shape, dtype, seed):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    scale = torch.randn(shape[-1], generator=gen, device=DEVICE)
    bias = torch.randn(shape[-1], generator=gen, device=DEVICE)
    return x, dy, scale, bias


def check_group_norm(gn, torch, name, shape, groups, relu, dtype, iters):
    """Both GroupNorm kernels against their plain versions on one case,
    each under the name of the path (one read or two) that the kernels'
    layout rule gives the shape; each row with its device time and
    ``F.group_norm``'s."""
    import torch.nn.functional as F

    from tfk8s_tpu_torch.tools.gn_sweep import bound_ms, device_ms, events_ms

    x, dy, scale, bias = _gn_inputs(shape, dtype, seed=len(name))
    bf16 = dtype == torch.bfloat16
    atol_y, atol_dx = (2e-2, 2e-2) if bf16 else (F32_OUT_ATOL, F32_GRAD_ATOL)
    rtol = BF16_RTOL if bf16 else 0.0
    fwd_name, bwd_name = (gn.kernel_name(shape, groups, dtype, bwd) for bwd in (False, True))
    gn.reset_launches()
    y_k, m_k, r_k = gn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu)
    y_p, m_p, r_p = gn.group_norm_fwd_plain(x, scale, bias, groups, relu=relu)
    # both backwards from the kernel's statistics, so the ReLU masks agree
    dx_k, ds_k, db_k = gn.group_norm_bwd_cuda(dy, x, scale, bias, m_k, r_k, groups, relu)
    dx_p, ds_p, db_p = gn.group_norm_bwd_plain(dy, x, scale, bias, m_k, r_k, groups, relu)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(gn.KERNELS, 0), fwd_name: 1, bwd_name: 1}
    if dict(gn.LAUNCHES) != want:
        raise AssertionError(f"{name}: group-norm launches {dict(gn.LAUNCHES)}, want {want}")
    for t in (y_k, dx_k, ds_k, db_k):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: a group-norm kernel output is not finite")
    e_fwd = _err([(y_k, y_p)], atol_y, rtol)
    e_stats = _err([(m_k, m_p), (r_k, r_p)], F32_OUT_ATOL, 1e-5)
    e_dx = _err([(dx_k, dx_p)], atol_dx, rtol)
    e_par = _err([(ds_k, ds_p), (db_k, db_p)], 1e-2, 1e-3)

    # the library yardstick: F.group_norm (+ relu) on the channels-last
    # NCHW view, and its autograd backward
    xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
    w_l = scale.to(dtype).requires_grad_()
    b_l = bias.to(dtype).requires_grad_()
    dyc = dy.permute(0, 3, 1, 2)

    def lib_fwd():
        with torch.no_grad():
            out = F.group_norm(xc, groups, w_l, b_l, eps=1e-6)
            return F.relu(out) if relu else out

    out_l = F.group_norm(xc, groups, w_l, b_l, eps=1e-6)
    out_l = F.relu(out_l) if relu else out_l

    def lib_bwd():
        return torch.autograd.grad(out_l, (xc, w_l, b_l), dyc, retain_graph=True)

    n, elt = x.numel(), x.element_size()
    runs = {
        fwd_name: (
            lambda: gn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu),
            lambda: gn.group_norm_fwd_plain(x, scale, bias, groups, relu=relu),
            lib_fwd, max(e_fwd[0], e_stats[0]), e_fwd[1] and e_stats[1],
            bound_ms(n, elt, False)),
        bwd_name: (
            lambda: gn.group_norm_bwd_cuda(dy, x, scale, bias, m_k, r_k, groups, relu),
            lambda: gn.group_norm_bwd_plain(dy, x, scale, bias, m_k, r_k, groups, relu),
            lib_bwd, max(e_dx[0], e_par[0]), e_dx[1] and e_par[1],
            bound_ms(n, elt, True)),
    }
    results = []
    for kname, (kern, plain, lib, worst, ok, bound) in runs.items():
        r = {
            "case": f"{name}_{str(dtype).replace('torch.', '')}", "kernel": kname,
            "shape": list(shape), "max_abs_err": worst, "ms": events_ms(kern, iters),
            "plain_ms": events_ms(plain, max(iters // 4, 1)), "bound_ms": bound,
            "bound_by": "bytes", "library_ms": events_ms(lib, iters),
            "device_ms": device_ms(kern, iters), "library_device_ms": device_ms(lib, iters),
        }
        log(f"  {json.dumps(r)}")
        if not ok:
            raise AssertionError(f"{r['case']}/{kname}: kernel disagrees with its plain version")
        results.append(r)
    return results


def gn_step_sweep():
    """Each GroupNorm kernel at every ResNet-50 norm site's shape (bfloat16,
    batch 256): its device time (profiler) and event time a site, and
    their sums a training step against the bounds, from
    ``tfk8s_tpu_torch/tools/gn_sweep.py``."""
    from tfk8s_tpu_torch.tools import gn_sweep

    out = gn_sweep.sweep(log=lambda line: log(f"  {line}"))
    if out["sites"] != RESNET_GN_SITES:
        raise AssertionError(f"{out['sites']} norm sites, want {RESNET_GN_SITES}")
    log(f"gn per ResNet-50 step (bf16, batch 256, {out['sites']} sites): "
        f"{json.dumps({k: v for k, v in out.items() if k != 'rows'})}")
    return out


def check_copy(bc, torch, iters):
    """The block copy against ``out.copy_(x)``: bit-exact."""
    from tfk8s_tpu_torch.tools.gn_sweep import HBM_BYTES_PER_S, events_ms

    rows, cols = COPY_SHAPE
    x = torch.randn(rows, cols, device=DEVICE)
    out_k = torch.full_like(x, float("nan"))
    bc.block_copy_cuda(x, out_k)
    out_p = bc.block_copy_plain(x)
    torch.cuda.synchronize()
    exact = torch.equal(out_k, out_p)
    spare = torch.empty_like(x)
    r = {
        "case": "copy_8192x8192_f32", "kernel": "block_copy",
        "max_abs_err": float((out_k - out_p).abs().max()),
        "ms": events_ms(lambda: bc.block_copy_cuda(x, spare), iters),
        "plain_ms": events_ms(lambda: bc.block_copy_plain(x, spare), iters),
        "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": events_ms(lambda: spare.copy_(x), iters),
    }
    log(f"  {json.dumps(r)}")
    if not exact:
        raise AssertionError("block copy is not bit-exact")
    return r


# Variants of the plain GroupNorm (``reference_group_norm``) that witness
# the end-to-end bound: "float64_stats" is sound (statistics rounded
# otherwise); each other one plants a fault a GroupNorm kernel could have.
GN_VARIANTS = ("float64_stats", "eps_1e-5", "one_pass_variance", "first_quarter_dropped",
               "groups_mismapped")


def gn_variant(kind: str):
    import torch

    def norm(x, scale, bias, groups, eps=1e-6, relu=False):
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h * w, groups, c // groups)
        if kind == "eps_1e-5":
            eps = 1e-5
        if kind == "first_quarter_dropped":  # one chunk's partials lost in the merge
            xf = xf[:, (h * w) // 4:]
        if kind == "float64_stats":
            xf = xf.double()
        mean = xf.mean(dim=(1, 3))
        if kind == "one_pass_variance":
            var = xf.square().mean(dim=(1, 3)) - mean.square()
        else:
            var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
        mean, rstd = mean.float(), torch.rsqrt(var + eps).float()
        # the group of each channel: c // (C / G), or c mod G when mismapped
        ch = torch.arange(c, device=x.device)
        gidx = ch % groups if kind == "groups_mismapped" else ch // (c // groups)
        y = (x.float() - mean[:, None, None, gidx]) * rstd[:, None, None, gidx]
        y = y * scale.float() + bias.float()
        return (y.clamp_min(0.0) if relu else y).to(x.dtype)

    return norm


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_build(_build):
    """Build every source; report ptxas's registers and spills for every
    tensor-core flash instantiation, the one-read GroupNorm kernels, the
    block copy and every instantiation that spills. A tensor-core or
    one-read GroupNorm instantiation that spills fails."""
    seconds, logs = _build.build_all(verbose=True)
    log(f"build: {seconds:.1f} s for {list(_build.SOURCES)}")
    entry, spilled = None, []
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not ("registers" in line or "spill" in line):
            continue
        spills = re.search(r"[1-9]\d* bytes spill", line) is not None
        name = re.search(r"tfk8s_\w+?_kernel", entry)
        tag = name.group(0) if name else entry
        wgmma = "wgmma" in tag or "dsum" in tag
        cluster = "cluster" in tag  # the one-read GroupNorm kernels
        head_dim = re.search(r"ILi(\d+)EE", entry)
        if head_dim and (wgmma or "simt" in tag):  # a flash kernel's head dim
            tag += f"<d={head_dim.group(1)}>"
        inst = re.search(r"cluster_kernelI(\w+?)Li(\d+)ELb(\d)E", entry)
        if inst:  # a GroupNorm instantiation: <type, vec, relu>
            dtype = "bf16" if "bfloat16" in inst.group(1) else "f32"
            tag += f"<{dtype},{inst.group(2)},{inst.group(3)}>"
        if wgmma or cluster or "block_copy" in tag or spills:
            log(f"  ptxas {tag}: {line.split(':', 1)[-1].strip()}")
        if spills and (wgmma or cluster):
            spilled.append(tag)
    if spilled:
        raise AssertionError(f"kernels spill: {sorted(set(spilled))}")


def phase_kernels(fa, torch):
    s = SLICE
    cases = [
        Case("slice_bf16_causal", s["b"], s["l"], s["l"], s["h"], s["d"], torch.bfloat16,
             causal=True, seed=1),
        Case("f32_key_mask_dead_row", 2, 96, 96, 3, 64, torch.float32,
             lengths=[70, 0], seed=2),
        Case("f32_causal_lq_lt_lk", 2, 77, 130, 3, 64, torch.float32, causal=True, seed=3),
        Case("f32_ragged_causal_mask", 3, 200, 200, 2, 64, torch.float32, causal=True,
             lengths=[200, 131, 5], seed=4),
        Case("bf16_ragged_d128", 2, 150, 150, 2, 128, torch.bfloat16, causal=True, seed=5),
        Case("bf16_d32_key_mask", 3, 333, 333, 4, 32, torch.bfloat16,
             lengths=[333, 120, 0], seed=6),
        # the slice's FLOPs at d=128 (half the heads, half the scores)
        Case("slice_bf16_causal_d128", s["b"], s["l"], s["l"], s["h"] // 2, 128, torch.bfloat16,
             causal=True, seed=7),
    ]
    line = {}
    for i, case in enumerate(cases):
        log(f"case {case.name}:")
        res = check_case(fa, case, iters=20 if i == 0 else 5, profile=i == 0)
        if i == 0:
            line.update((r["kernel"], r) for r in res)
    from tfk8s_tpu_torch.ops import block_copy as bc
    from tfk8s_tpu_torch.ops import group_norm as gn

    for i, (name, shape, groups, relu) in enumerate(GN_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            log(f"case {name} {dtype}:")
            res = check_group_norm(gn, torch, name, shape, groups, relu, dtype, iters=10)
            if dtype == torch.bfloat16:  # the first case's row of each kernel
                line.update((r["kernel"], r) for r in res if r["kernel"] not in line)
            torch.cuda.empty_cache()
    gn_step_sweep()
    log("case copy:")
    line["block_copy"] = check_copy(bc, torch, iters=20)
    return line


def phase_reference(torch, gpt, fa):
    """Small f32 GPT: kernels on the card vs plain versions on the CPU;
    base-width bf16 loss and gradients: kernels vs plain attention on the
    card, and planted dq and dk/dv faults that the gradient bounds must
    catch."""
    import copy

    import numpy as np

    cfg = gpt.mid_config(dtype=torch.float32)
    task = gpt.make_task(cfg, seq_len=64, batch_size=2, attn_fn=fa.flash_attention)
    cpu = task.init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(DEVICE)
    ids = torch.from_numpy(task.make_batch(np.random.default_rng(0), 2)["input"])
    losses, grads = [], []
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        x = ids.to(dev)
        loss, _ = gpt.lm_loss_and_metrics(model(x), x)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    g_err = max(float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[0])
    l_err = abs(losses[0] - losses[1])
    log(f"reference f32 mid: loss cpu {losses[0]:.6f} card {losses[1]:.6f} "
        f"err {l_err:.2e}, max grad err {g_err:.2e} (atol {F32_GRAD_ATOL})")
    if not (l_err <= F32_GRAD_ATOL and g_err <= F32_GRAD_ATOL):
        raise AssertionError("card kernels disagree with the CPU plain path")

    cfg = getattr(gpt, BASE_CHECK["preset"])()
    seq, batch = BASE_CHECK["seq"], BASE_CHECK["batch"]
    base = gpt.make_task(cfg, seq_len=seq, batch_size=batch).init(torch.Generator().manual_seed(1))
    base = base.to(DEVICE)
    ids = torch.from_numpy(
        gpt.make_batch_fn(cfg.vocab_size, seq)(np.random.default_rng(1), batch)["input"]
    ).to(DEVICE)
    real_bwd = fa.flash_bwd

    def planted(which):
        """The backward with D = rowsum(dO * O) taken as zero in dq or in
        dk/dv only: the kernels run on o = 0, so the pre-pass gives D = 0."""
        def bwd(q, k, v, do, o, lse, mask=None, causal=False):
            good = real_bwd(q, k, v, do, o, lse, mask, causal)
            bad = real_bwd(q, k, v, do, torch.zeros_like(o), lse, mask, causal)
            return (bad[0], *good[1:]) if which == "dq" else (good[0], *bad[1:])
        return bwd

    runs = (("full", None, real_bwd), ("flash", fa.flash_attention, real_bwd),
            ("fault_dkv", fa.flash_attention, planted("dkv")),
            ("fault_dq", fa.flash_attention, planted("dq")))
    losses, grads = {}, {}
    for impl, fn, bwd in runs:
        for layer in base.layers:
            layer.attn.attn_fn = fn
        base.zero_grad(set_to_none=True)
        fa.flash_bwd = bwd
        try:
            logits = base(ids)
            if not torch.isfinite(logits).all() or logits.shape != (batch, seq, cfg.vocab_size):
                raise AssertionError(f"base {impl}: bad logits {tuple(logits.shape)}")
            loss = gpt.lm_loss_and_metrics(logits, ids)[0]
            loss.backward()
        finally:
            fa.flash_bwd = real_bwd
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.float() for n, p in base.named_parameters()}

    def rel_l2(impl, names):
        num = sum(float((grads[impl][n] - grads["full"][n]).square().sum()) for n in names)
        return math.sqrt(num / sum(float(grads["full"][n].square().sum()) for n in names))

    # the bounds hold the key and value projections, whose gradients come
    # from dk and dv alone, and the query projection, whose gradients come
    # from dq alone; all parameters together are reported beside
    kv_names = [n for n in grads["full"] if re.search(r"attn\.(k|v)\.", n)]
    q_names = [n for n in grads["full"] if re.search(r"attn\.q\.", n)]
    if not kv_names or not q_names:
        raise AssertionError("no query, key or value projection parameters found")
    impls = ("flash", "fault_dkv", "fault_dq")
    err = abs(losses["full"] - losses["flash"])
    rel_kv = {impl: rel_l2(impl, kv_names) for impl in impls}
    rel_q = {impl: rel_l2(impl, q_names) for impl in impls}
    every = {impl: rel_l2(impl, list(grads["full"])) for impl in impls}
    log(f"reference bf16 base: loss full {losses['full']:.6f} flash {losses['flash']:.6f} "
        f"err {err:.2e} (atol {BF16_ATOL}); grads rel L2 vs full, flash / planted dk/dv "
        f"fault (D = 0) / planted dq fault (D = 0): k/v projections ({len(kv_names)} "
        f"tensors) {rel_kv['flash']:.3e} / {rel_kv['fault_dkv']:.3e} / "
        f"{rel_kv['fault_dq']:.3e} (bound {BASE_GRAD_REL_L2}); q projection "
        f"({len(q_names)} tensors) {rel_q['flash']:.3e} / {rel_q['fault_dkv']:.3e} / "
        f"{rel_q['fault_dq']:.3e} (bound {BASE_Q_GRAD_REL_L2}); every parameter "
        f"{every['flash']:.3e} / {every['fault_dkv']:.3e} / {every['fault_dq']:.3e}")
    if not err <= BF16_ATOL:
        raise AssertionError("base-width flash loss disagrees with plain attention")
    if not (rel_kv["flash"] <= BASE_GRAD_REL_L2 and rel_q["flash"] <= BASE_Q_GRAD_REL_L2):
        raise AssertionError("base-width flash gradients disagree with plain attention")
    if not rel_kv["fault_dkv"] > BASE_GRAD_REL_L2:
        raise AssertionError("the planted dk/dv fault passes the k/v gradient bound")
    if not rel_q["fault_dq"] > BASE_Q_GRAD_REL_L2:
        raise AssertionError("the planted dq fault passes the q gradient bound")
    for layer in base.layers:
        layer.attn.attn_fn = None
    del base, grads


def phase_train(torch, gpt, fa, ckpt_dir):
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    env = dict(TRAIN_ENV, TFK8S_CHECKPOINT_DIR=ckpt_dir)
    tiny = env.get("TFK8S_MODEL_PRESET") == "tiny"
    layers = (gpt.tiny_config() if tiny else gpt.base_config()).num_layers
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    history = gpt.train(env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in history]
    # history[i] has steps_per_s = step_i / (t_i - t0): steady-state step
    # time from the first and last entries leaves the first step out
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"])
    tokens = int(env["TFK8S_BATCH_SIZE"]) * int(env["TFK8S_SEQ_LEN"])
    summary = {
        "steps": TRAIN_STEPS, "wall_s": wall, "first_step_s": t_first,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_mem_gib": peak_gib, "first_loss": losses[0], "last_loss": losses[-1],
        "launches": launches,
    }
    log(f"train: {json.dumps(summary)}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    # bf16 training: each tensor-core kernel once per layer and step (one
    # pre-pass feeds dq and dk/dv); the float32 CUDA-core kernels never
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * TRAIN_STEPS)}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, want {want}")
    latest = Checkpointer(ckpt_dir).latest_step()
    log(f"checkpoint: latest_step {latest}")
    if latest != TRAIN_STEPS:
        raise AssertionError(f"latest committed step {latest}, want {TRAIN_STEPS}")
    return launches


def phase_resnet_reference(torch, resnet, gn):
    """Small float32 ResNet-50: GroupNorm kernels on the card vs plain
    versions on the CPU; ResNet-50 at full width in float32 and in
    bfloat16: kernel GroupNorm vs plain GroupNorm on the card, same input,
    and in bfloat16 the variants of ``gn_variant`` against the bound."""
    import copy

    import numpy as np

    from tfk8s_tpu_torch.ops.group_norm import reference_group_norm

    def randomized(width, classes, seed, dtype):
        """ResNet-50 with a random classifier and last-norm scales (both
        zero at init, which would leave most gradients zero)."""
        model = resnet.init_params(resnet.ResNet(50, classes, width, dtype),
                                   torch.Generator().manual_seed(seed))
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            model.classifier.weight.normal_(0.0, 0.1, generator=gen)
            for name in model.block_names:
                getattr(model, name).norm3.weight.normal_(0.0, 1.0, generator=gen)
        return model

    # float32 compute throughout (TF32 is off for the card's convs)
    cpu = randomized(8, 8, 0, torch.float32)
    card = copy.deepcopy(cpu).to(DEVICE)
    batch = resnet.make_batch_fn(8, 64)(np.random.default_rng(0), 4)
    losses, grads = [], []
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        gn.reset_launches()
        x = torch.from_numpy(batch["image"]).to(dev)
        y = torch.from_numpy(batch["label"]).to(dev)
        logits = model(x)
        loss, _ = resnet.loss_and_metrics(logits, y)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    # every site through the one-read kernels, forward and backward
    want = {**dict.fromkeys(gn.TWO_READ_KERNELS, 0),
            **dict.fromkeys(gn.ONE_READ_KERNELS, RESNET_GN_SITES)}
    if dict(gn.LAUNCHES) != want:
        raise AssertionError(f"card pass launched {dict(gn.LAUNCHES)}, want {want}")
    num = sum(float((grads[0][n] - grads[1][n]).square().sum()) for n in grads[0])
    den = sum(float(grads[0][n].square().sum()) for n in grads[0])
    g_rel, l_err = math.sqrt(num / den), abs(losses[0] - losses[1])
    log(f"resnet reference f32 (width 8, image 64): loss cpu {losses[0]:.6f} card "
        f"{losses[1]:.6f} err {l_err:.2e}, grad rel L2 err {g_rel:.2e} (1e-3)")
    if not (l_err <= F32_GRAD_ATOL and g_rel <= 1e-3):
        raise AssertionError("ResNet on the card disagrees with the CPU plain path")

    # ResNet-50 at full width, one input: kernel vs plain GroupNorm in
    # float32, then in bfloat16 beside variants of the plain GroupNorm
    batch = resnet.make_batch_fn(1000, 224)(np.random.default_rng(1), 8)
    x = torch.from_numpy(batch["image"]).to(DEVICE)

    def logits_with(model, norm):
        resnet.fused_group_norm = norm
        try:
            with torch.no_grad():
                out = model(x)
        finally:
            resnet.fused_group_norm = gn.fused_group_norm
        if not torch.isfinite(out).all() or out.shape != (8, 1000):
            raise AssertionError(f"resnet50: bad logits {tuple(out.shape)}")
        return out.float()

    def rel_err(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    model = randomized(64, 1000, 2, torch.float32).to(DEVICE)
    e32 = rel_err(logits_with(model, gn.fused_group_norm), logits_with(model, reference_group_norm))
    log(f"resnet reference f32 ResNet-50 (width 64, batch 8): logits max |kernel - plain| "
        f"{e32:.3e} of max |logit| (bound {RESNET50_F32_LOGIT_RTOL})")
    if not e32 <= RESNET50_F32_LOGIT_RTOL:
        raise AssertionError("ResNet-50 f32 logits: kernel GroupNorm disagrees with plain")

    model = randomized(64, 1000, 2, torch.bfloat16).to(DEVICE)
    plain = logits_with(model, reference_group_norm)
    rel = {"kernel": rel_err(logits_with(model, gn.fused_group_norm), plain)}
    for kind in GN_VARIANTS:
        rel[kind] = rel_err(logits_with(model, gn_variant(kind)), plain)
    log(f"resnet reference bf16 ResNet-50 (batch 8): logits max |variant - plain| of max "
        f"|logit| (bound {RESNET50_BF16_LOGIT_RTOL}): {json.dumps(rel)}")
    for kind in ("kernel", "float64_stats"):
        if not rel[kind] <= RESNET50_BF16_LOGIT_RTOL:
            raise AssertionError(f"ResNet-50 bf16 logits: {kind} GroupNorm disagrees with plain")
    for kind in RESNET50_FAULTS_CAUGHT:
        if not rel[kind] > RESNET50_BF16_LOGIT_RTOL:
            raise AssertionError(f"ResNet-50 bf16 logits: the planted fault {kind} passes")


def phase_resnet_train(torch, resnet, gn, ckpt_dir):
    from tfk8s_tpu_torch.runtime import progress
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    env = dict(RESNET_ENV, TFK8S_CHECKPOINT_DIR=ckpt_dir)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    progress.clear()
    gn.reset_launches()
    t0 = time.perf_counter()
    history = resnet.train(env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gn.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prog = progress.snapshot()
    losses = [h["loss"] for h in history]
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"])
    summary = {
        "steps": RESNET_STEPS, "wall_s": wall, "first_step_s": t_first,
        "step_ms": step_s * 1e3, "images_per_s": int(env["TFK8S_BATCH_SIZE"]) / step_s,
        "peak_mem_gib": peak_gib, "first_loss": losses[0], "last_loss": losses[-1],
        "input_wait_seconds": prog.get("input_wait_seconds"),
        "input_starved_steps": prog.get("input_starved_steps"),
        "launches": launches,
    }
    log(f"resnet train: {json.dumps(summary)}")
    if len(losses) != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    # one launch of each one-read kernel per norm site and step, no two-read one
    want = {**dict.fromkeys(gn.TWO_READ_KERNELS, 0),
            **dict.fromkeys(gn.ONE_READ_KERNELS, RESNET_GN_SITES * RESNET_STEPS)}
    if launches != want:
        raise AssertionError(f"group-norm launches {launches}, want {want}")
    latest = Checkpointer(ckpt_dir).latest_step()
    log(f"checkpoint: latest_step {latest}")
    if latest != RESNET_STEPS:
        raise AssertionError(f"latest committed step {latest}, want {RESNET_STEPS}")
    return launches


def phase_roofline(torch, bc):
    from tfk8s_tpu_torch.tools import roofline

    torch.cuda.empty_cache()
    bc.reset_launches()
    out = roofline.run_all(small=False, device=DEVICE)
    launches = dict(bc.LAUNCHES)
    log(json.dumps(out))
    if out.get("degraded_probes"):
        raise AssertionError(f"roofline probes failed: {out['degraded_probes']}")
    if launches["block_copy"] == 0:
        raise AssertionError("the copy probe never launched the block-copy kernel")
    return launches


def _device_busy_ms(torch, prof):
    """(union of the card's activity intervals in a profiler trace, in ms;
    the number of activities)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy * 1e-3, len(spans)


def _timed(torch, fn, profiled=False):
    """(result, wall ms) of one synced call, with (device ms, activities)
    from a profiler trace of a second call when ``profiled``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if not profiled:
        return out, wall, None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return out, wall, _device_busy_ms(torch, prof)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _greedy_check(torch, model, prompts, tokens, others=()):
    """Each row's generated tokens against the full forward's argmax over
    the sequence so far: a position may differ only where both logits lie
    within GENERATE_F32_TIE_ATOL. ``others`` are other decoders' tokens for
    the same prompts, held to the same rule: up to the first position where
    they part, which must be such a tie. Returns (checked, ties)."""
    import numpy as np

    checked, ties = 0, 0
    for r, prompt in enumerate(prompts):
        seqs = [tokens[r]] + [o[r] for o in others]
        for s_i, toks in enumerate(seqs):
            seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
            with torch.no_grad():
                logits = model(torch.from_numpy(seq)[None].to(DEVICE))[0]
            plen = len(prompt)
            rows = logits[plen - 1:plen - 1 + len(toks)]
            full = rows.argmax(-1).tolist()
            for t, (a, b) in enumerate(zip(toks, full)):
                checked += 1
                if s_i > 0 and a != tokens[r][t]:
                    gap = abs(float(rows[t, a] - rows[t, tokens[r][t]]))
                    if gap > GENERATE_F32_TIE_ATOL:
                        raise AssertionError(
                            f"row {r}: decoder {s_i} parts from generate at step {t} "
                            f"({a} vs {tokens[r][t]}, logit gap {gap:.3e})")
                    ties += 1
                    break
                if a != b:
                    gap = float(rows[t, b] - rows[t, a])
                    if gap > GENERATE_F32_TIE_ATOL:
                        raise AssertionError(
                            f"row {r}: token {a} != full-forward argmax {b} at step {t} "
                            f"(logit gap {gap:.3e})")
                    ties += 1
    return checked, ties


def phase_generate(torch, gpt, fa):
    """Slot-per-batch KV-cache generation at GPT-2-small base width on the
    card, through ``gpt.generate``/``gpt.beam_generate``: prefill through
    the bf16 flash forward kernel (12 launches a prefill), greedy and
    sampled streams, EOS, beams; float32 tokens against the full forward
    and the paged decode loop; bf16 prefill logits, flash vs plain, against
    a bound a non-causal flash call must exceed; the flash forward at the
    prefill's shape against its plain version and SDPA."""
    import dataclasses

    import numpy as np

    from tfk8s_tpu_torch.runtime import server

    g = GENERATE
    b, plen, n = g["batch"], g["prompt"], g["gen"]
    cfg = gpt.base_config(attention_impl="flash")
    layers = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = server.GptGenerator("seed:0", b, gen_tokens=n, cfg=cfg, device=DEVICE)
    gen.load()
    model = gen.module
    rng = np.random.default_rng(g["seed"])
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, plen))).to(DEVICE)

    def counted(fn):
        fa.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(fa.LAUNCHES)

    want_prefill = {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd_wgmma": layers}
    # warm-up, then the main path: one greedy generate, counted
    gpt.generate(cfg, model, prompts, n)
    greedy, launches = counted(lambda: gpt.generate(cfg, model, prompts, n))
    if launches != want_prefill:
        raise AssertionError(f"generate launches {launches}, want {want_prefill}")
    _, gen_ms, gen_dev = _timed(torch, lambda: gpt.generate(cfg, model, prompts, n),
                                profiled=True)
    _, prefill_ms, prefill_dev = _timed(
        torch, lambda: gpt.prefill_cache(dataclasses.replace(cfg, decode_cache_len=plen + n),
                                         model, prompts), profiled=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    decode_ms = (gen_ms - prefill_ms) / (n - 1)
    decode_dev = (gen_dev[0] - prefill_dev[0]) / (n - 1)
    g_np = greedy.cpu().numpy()
    if not ((0 <= g_np) & (g_np < cfg.vocab_size)).all() or g_np.shape != (b, n):
        raise AssertionError(f"greedy tokens malformed: {g_np.shape}")

    samp = dict(temperature=0.8, top_k=50, top_p=0.95)
    (sampled, launches_s) = counted(lambda: gpt.generate(cfg, model, prompts, n, rng=g["key"],
                                                         **samp))
    again = gpt.generate(cfg, model, prompts, n, rng=g["key"], **samp)
    top1 = gpt.generate(cfg, model, prompts, n, rng=g["key"], **dict(samp, top_k=1))
    if launches_s != want_prefill:
        raise AssertionError(f"sampled generate launches {launches_s}, want {want_prefill}")
    if not torch.equal(sampled, again):
        raise AssertionError("the same key gave another sampled stream")
    if not torch.equal(top1, greedy):
        raise AssertionError("top_k=1 sampling differs from greedy")

    eos = int(g_np[0, n // 2])
    stopped = gpt.generate(cfg, model, prompts, n, eos_id=eos).cpu().numpy()
    for r in range(b):
        hits = np.flatnonzero(g_np[r] == eos)
        end = hits[0] + 1 if hits.size else n
        if not (np.array_equal(stopped[r, :end], g_np[r, :end]) and (stopped[r, end:] == 0).all()):
            raise AssertionError(f"row {r}: EOS {eos} did not stop and pad the stream")

    bb, bplen, bn, beams = g["beam_batch"], g["beam_prompt"], g["beam_gen"], g["beams"]
    bprompt = prompts[:bb, :bplen]
    (seqs, scores), beam_ms, _ = _timed(torch, lambda: gpt.beam_generate(
        cfg, model, bprompt, bn, num_beams=beams, return_all=True))
    one = gpt.beam_generate(cfg, model, bprompt, bn, num_beams=1)
    if not torch.equal(one, gpt.greedy_generate(cfg, model, bprompt, bn)):
        raise AssertionError("num_beams=1 differs from greedy")
    if not (torch.isfinite(scores).all() and (scores[:, 1:] <= scores[:, :-1]).all()):
        raise AssertionError(f"beam scores not finite or not sorted: {scores}")

    # bf16 prefill logits: flash against plain attention, and a planted
    # fault (the flash kernel called non-causal) that must exceed the bound
    plain_cfg = dataclasses.replace(cfg, attention_impl="full", decode_cache_len=plen + n)
    flash_logits, _ = gpt.prefill_cache(dataclasses.replace(cfg, decode_cache_len=plen + n),
                                        model, prompts)
    plain_logits, _ = gpt.prefill_cache(plain_cfg, model, prompts)
    rel = _rel_l2(flash_logits, plain_logits)
    del flash_logits
    with torch.no_grad():
        fault_logits, _ = gpt.mode_view(model, sow_kv=True)(
            prompts, attn_fn=lambda q, k, v, mask=None, causal=False:
            fa.flash_attention(q, k, v, mask, causal=False))
    fault_rel = _rel_l2(fault_logits, plain_logits)
    del fault_logits, plain_logits, gen, model
    torch.cuda.empty_cache()

    # float32 (TF32 off): generate's greedy tokens against the full
    # forward's argmax and against the paged decode loop's tokens
    f32_cfg = gpt.base_config(dtype=torch.float32, attention_impl="flash")
    f32 = server.GptGenerator("seed:0", g["f32_rows"], gen_tokens=n, cfg=f32_cfg, device=DEVICE)
    f32.load()
    f_prompts = prompts[:g["f32_rows"]]
    f_tokens = gpt.generate(f32_cfg, f32.module, f_prompts, n).cpu().numpy()
    paged = server.PagedGptDecoder(
        "seed:0", slots=g["f32_rows"], page_size=16, max_pages=g["f32_rows"] * 64 + 1,
        gen_tokens=n, cfg=f32_cfg, params=f32.module.state_dict(), device=DEVICE)
    paged.load()
    loop = server.DecodeLoopExecutor(paged).start()
    try:
        paged_tokens = [r["tokens"] for r, _, _ in _submit_all(
            loop, [{"tokens": p.cpu().numpy().astype(np.int32), "gen_tokens": n}
                   for p in f_prompts])]
    finally:
        loop.drain(60)
    checked, ties = _greedy_check(torch, f32.module, [p.cpu().numpy() for p in f_prompts],
                                  f_tokens.tolist(), others=(paged_tokens,))
    same_as_paged = sum(list(a) == list(p) for a, p in zip(f_tokens.tolist(), paged_tokens))
    del f32, paged, loop
    torch.cuda.empty_cache()

    # the flash forward at the prefill's shape: kernel against its plain
    # version and SDPA, with profiler device times
    rows = check_case(fa, Case("prefill_bf16_causal", b, plen, plen, cfg.num_heads,
                               cfg.head_dim, torch.bfloat16,
                               causal=True, seed=8), iters=20, profile=True)
    fwd_row = next(r for r in rows if r["kernel"] == "flash_fwd_wgmma")
    summary = {
        "batch": b, "prompt": plen, "gen_tokens": n, "prefill_ms": prefill_ms,
        "prefill_device_ms": prefill_dev[0], "generate_ms": gen_ms,
        "generate_device_ms": gen_dev[0], "generate_activities": gen_dev[1],
        "decode_token_ms": decode_ms, "decode_token_device_ms": decode_dev,
        "decode_idle_share": 1.0 - decode_dev / decode_ms,
        "tokens_per_s": b * n / (gen_ms * 1e-3), "peak_mem_gib": peak_gib,
        "flash_fwd_launches_per_generate": launches["flash_fwd_wgmma"],
        "sampled_repeat_equal": True, "top_k1_equals_greedy": True, "eos_id": eos,
        "beam": {"batch": bb, "prompt": bplen, "gen": bn, "beams": beams, "ms": beam_ms,
                 "best_scores": scores[:, 0].tolist()},
        "prefill_logits_rel_l2_flash_vs_plain": rel,
        "prefill_logits_rel_l2_noncausal_fault": fault_rel,
        "f32": {"rows": g["f32_rows"], "tokens_checked": checked, "near_ties": ties,
                "rows_equal_to_paged": same_as_paged},
        "flash_fwd_at_prefill_shape": fwd_row,
    }
    log(f"generate: {json.dumps(summary)}")
    if rel > GENERATE_LOGIT_REL_L2:
        raise AssertionError(f"bf16 prefill logits flash vs plain {rel:.3e} > "
                             f"{GENERATE_LOGIT_REL_L2}")
    if fault_rel <= GENERATE_LOGIT_REL_L2:
        raise AssertionError(f"the non-causal fault {fault_rel:.3e} passes the bound")
    return {"flash_fwd_wgmma": launches["flash_fwd_wgmma"]}


def _serve_requests(n, vocab, seed=0):
    """The mixed workload: prompt lengths 16-512, a third sampled, a third
    opening with one shared 256-token prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, SERVE["shared_prefix"]).astype(np.int32)
    out = []
    for i in range(n):
        plen = int(rng.integers(SERVE["prompt_min"], SERVE["prompt_max"] + 1))
        tokens = rng.integers(1, vocab, plen).astype(np.int32)
        if i % 3 == 1:
            tail = max(plen - SERVE["shared_prefix"], SERVE["prompt_min"])
            tokens = np.concatenate([shared, tokens[:tail]])
        payload = {"tokens": tokens, "gen_tokens": SERVE["gen"]}
        if i % 3 == 2:
            payload["sampling"] = dict(SERVE_SAMPLING, seed=1000 + i)
        out.append(payload)
    return out


def _submit_all(replica, payloads):
    """Submit concurrently; (result, submit time, done time) per request.
    Raises when a request fails."""
    runs = _run_each([lambda p=p: replica.submit(p, timeout=SERVE["timeout_s"])
                      for p in payloads])
    _results(runs, "submit")
    return runs


def _decode_step_times(torch, decoder, sampled):
    """One decode step of 8 live rows at mid-length positions: its wall
    time (host launch and sync included, no profiler) and its device time
    (the union of the card's activity intervals in a profiler trace),
    each over SERVE["profile_steps"] steps; idle share = 1 - device/wall."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    slots, mpp, ps = decoder.slots, decoder.pages_per_slot, decoder.page_size
    per_row = (decoder.max_pages - 1) // slots
    state = np.zeros((slots, 2 + mpp), np.int32)
    for r in range(slots):
        state[r, 0] = 1 + r
        state[r, 1] = min(per_row, mpp) * ps // 2
        n = min(per_row, mpp)
        state[r, 2:2 + n] = np.arange(1 + r * per_row, 1 + r * per_row + n)
    samp = None
    if sampled:
        samp = (np.tile(np.array([[SERVE_SAMPLING["temperature"], SERVE_SAMPLING["top_p"]]],
                                 np.float32), (slots, 1)),
                np.stack([np.full(slots, SERVE_SAMPLING["top_k"]), np.arange(slots)], 1)
                .astype(np.int32))
    n = SERVE["profile_steps"]

    def run():
        st = state
        for _ in range(n):
            _, st = decoder.decode(st, samp)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    busy, activities = _device_busy_ms(torch, prof)
    device_ms = busy / n if busy else None
    return {
        "step_ms": wall_ms, "device_ms": device_ms,
        "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
        "tokens_per_s": slots / (wall_ms * 1e-3), "device_activities": activities // n,
    }


def phase_serve(torch, gpt, kernel_modules):
    """The TPUServe entrypoint at base width on the card: the mixed
    workload, the alone-vs-batched sampled streams, the bucketed greedy
    requests, the float32 paged-vs-full check, one decode step's time and
    device-idle share; then the slot-per-batch executor on the bucketed
    requests, and ``echo`` and ``mlp``."""
    import numpy as np

    from tfk8s_tpu_torch.runtime import server
    from tfk8s_tpu_torch.utils.logging import Metrics

    metrics = Metrics()
    server.set_metrics(metrics)
    env = dict(SERVE_ENV, TFK8S_DEVICE=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_modules:
        mod.reset_launches()
    t_load = time.perf_counter()
    replica, stop, thread, errors = _run_serve(server, env)
    load_s = time.perf_counter() - t_load
    decoder = replica.model
    payloads = _serve_requests(SERVE["requests"], decoder.vocab_size)
    t0 = time.perf_counter()
    results = _submit_all(replica, payloads)
    wall = time.perf_counter() - t0
    alone = {}
    for i, p in enumerate(payloads):
        if "sampling" in p:
            alone[i] = replica.submit(p, timeout=SERVE["timeout_s"])["tokens"]
    prefix_hits = replica.allocator.prefix_hits
    bucketed = _legacy_requests(decoder.vocab_size)
    loop_bucketed = _latency_summary(_submit_all(
        replica, [{"tokens": p, "gen_tokens": LEGACY["gen"]} for p in bucketed]))
    _stop_serve(stop, thread, errors)
    launches = {k: v for mod in kernel_modules for k, v in mod.LAUNCHES.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    outs = [r["tokens"] for r, _, _ in results]
    short = [i for i, o in enumerate(outs) if len(o) != SERVE["gen"]]
    if short:
        raise AssertionError(f"requests {short} did not complete {SERVE['gen']} tokens")
    bad = [t for o in outs for t in o if not 0 <= t < decoder.vocab_size]
    if bad:
        raise AssertionError(f"out-of-vocab tokens {bad[:5]}")
    differ = [i for i, toks in alone.items() if toks != outs[i]]
    ttft = np.array([r["ttft_s"] for r, _, _ in results])
    snap = metrics.snapshot()["histograms"]
    tpot = [v for k, v in snap.items() if k.startswith("tfk8s_serving_tpot_seconds")]
    tpot_mean = sum(v["sum"] for v in tpot) / max(sum(v["count"] for v in tpot), 1)
    greedy = _decode_step_times(torch, decoder, sampled=False)
    sampled = _decode_step_times(torch, decoder, sampled=True)
    del replica, decoder
    torch.cuda.empty_cache()
    f32 = _serve_f32_check(torch, gpt, server, payloads)
    legacy = _serve_legacy(torch, server, bucketed, kernel_modules)
    others = _serve_echo_and_mlp(server)
    summary = {
        "requests": len(outs), "gen_tokens": SERVE["gen"], "load_s": load_s,
        "wall_s": wall, "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)), "tpot_mean_s": tpot_mean,
        "output_tokens_per_s": sum(map(len, outs)) / wall, "peak_mem_gib": peak_gib,
        "prefix_cache_hits": prefix_hits, "sampled_alone_equal": len(alone) - len(differ),
        "sampled_requests": len(alone), "decode_step_greedy": greedy,
        "decode_step_sampled": sampled, "f32_check": f32, "kernel_launches": launches,
        "bucketed_decode_loop": loop_bucketed, "bucketed_legacy": legacy,
        "echo_and_mlp": others,
    }
    log(f"serve: {json.dumps(summary)}")
    if differ:
        raise AssertionError(f"sampled requests {differ} differ alone vs in the batch")
    if any(launches.values()):
        raise AssertionError(f"the serving path launched port kernels: {launches}")
    if prefix_hits < 1:
        raise AssertionError("no request reused the shared prefix's pages")
    return summary


def _legacy_requests(vocab):
    """LEGACY's greedy prompts: 8 of each bucket length, in shuffled order."""
    import numpy as np

    rng = np.random.default_rng(LEGACY["seed"])
    lengths = rng.permutation(np.repeat(LEGACY["buckets"], LEGACY["per_bucket"]))
    return [rng.integers(1, vocab, int(n)).astype(np.int32) for n in lengths]


def _latency_summary(results):
    """Latency p50/p99 (submit to reply) and output tokens/s of one
    concurrent run; every reply must hold LEGACY["gen"] tokens."""
    import numpy as np

    lat = np.array([t1 - t0 for _, t0, t1 in results])
    toks = [r["tokens"] for r, _, _ in results]
    if any(len(t) != LEGACY["gen"] for t in toks):
        raise AssertionError("a bucketed request did not complete its tokens")
    wall = max(t1 for _, _, t1 in results) - min(t0 for _, t0, _ in results)
    return {"requests": len(results), "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)), "wall_s": wall,
            "output_tokens_per_s": sum(map(len, toks)) / wall}


def _run_serve(server, env):
    """Start ``server.serve(env, stop)`` on a thread; (replica, stop,
    thread, errors) once the replica is registered."""
    return _run_serves(server, [env])[0]


def _run_serves(server, envs):
    """Start one ``server.serve(env, stop)`` thread for each env at once
    (their loads overlap); (replica, stop, thread, errors) for each, once
    all are registered."""
    import threading

    started = []
    for env in envs:
        stop, errors = threading.Event(), []

        def entry(env=env, stop=stop, errors=errors):
            try:
                server.serve(env, stop)
            except BaseException as e:  # noqa: BLE001 — re-raised by _stop_serve
                errors.append(e)

        thread = threading.Thread(target=entry, name="serve-entry", daemon=True)
        thread.start()
        started.append((f"default/{env['TFK8S_POD_NAME']}", stop, thread, errors))
    out = []
    try:
        for key, stop, thread, errors in started:
            while server.lookup_replica(key) is None:
                if errors or not thread.is_alive():
                    raise RuntimeError(f"serve did not come up: {errors}")
                time.sleep(0.05)
            out.append((server.lookup_replica(key), stop, thread, errors))
    except BaseException:
        for _key, stop, _thread, _errors in started:
            stop.set()
        raise
    return out


def _stop_serve(stop, thread, errors):
    stop.set()
    thread.join(timeout=120)
    if errors or thread.is_alive():
        raise RuntimeError(f"serve did not exit cleanly: {errors}")


def _serve_legacy(torch, server, prompts, kernel_modules):
    """The slot-per-batch executor (``TFK8S_SERVE_DECODE_LOOP=0``) through
    ``server.serve`` at base width, max batch 8, on the bucketed prompts:
    latency, output tokens/s and peak memory; every reply 64 tokens. Its
    prefill at 512 tokens or fewer takes plain attention under the "auto"
    policy, so no kernel of the port launches."""
    env = dict(SERVE_ENV, TFK8S_DEVICE=DEVICE, TFK8S_SERVE_DECODE_LOOP="0",
               TFK8S_SERVE_GEN_TOKENS=str(LEGACY["gen"]),
               TFK8S_POD_NAME="chip-smoke-legacy")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_modules:
        mod.reset_launches()
    replica, stop, thread, errors = _run_serve(server, env)
    try:
        out = _latency_summary(_submit_all(replica, prompts))
        out["batches"] = replica.batches_total
    finally:
        _stop_serve(stop, thread, errors)
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v for mod in kernel_modules for k, v in mod.LAUNCHES.items()}
    if any(launches.values()):
        raise AssertionError(f"the legacy path launched port kernels: {launches}")
    return out


def _serve_echo_and_mlp(server):
    """``echo`` and ``mlp`` through ``server.serve``: a few requests each."""
    import numpy as np

    out = {}
    for task in ("echo", "mlp"):
        env = {"TFK8S_SERVE_TASK": task, "TFK8S_SERVE_CHECKPOINT": "seed:0",
               "TFK8S_DEVICE": DEVICE, "TFK8S_POD_NAME": f"chip-smoke-{task}"}
        replica, stop, thread, errors = _run_serve(server, env)
        try:
            rng = np.random.default_rng(0)
            payloads = ([float(i) for i in range(4)] if task == "echo" else
                        [rng.standard_normal(784).astype(np.float32) for _ in range(4)])
            replies = [r for r, _, _ in _submit_all(replica, payloads)]
        finally:
            _stop_serve(stop, thread, errors)
        if task == "echo" and [r["echo"] for r in replies] != payloads:
            raise AssertionError(f"echo replies {replies}")
        if task == "mlp" and not all(0 <= r["label"] < 10 for r in replies):
            raise AssertionError(f"mlp replies {replies}")
        out[task] = [r.get("label", r.get("echo")) for r in replies]
    return out


def _serve_f32_check(torch, gpt, server, payloads):
    """Float32 at base width, TF32 off: 4 greedy requests through the
    paged decoder; each emitted token must be the argmax of the non-paged
    full forward at its position (one causal forward over prompt + output
    gives every position's prediction over the sequence so far)."""
    import numpy as np

    decoder = server.PagedGptDecoder(
        "seed:0", slots=int(SERVE_ENV["TFK8S_SERVE_MAX_BATCH"]),
        page_size=int(SERVE_ENV["TFK8S_SERVE_PAGE_SIZE"]),
        max_pages=int(SERVE_ENV["TFK8S_SERVE_MAX_PAGES"]), gen_tokens=SERVE["gen"],
        size="base", cfg=gpt.base_config(dtype=torch.float32), device=DEVICE)
    decoder.load()
    loop = server.DecodeLoopExecutor(decoder).start()
    greedy = [p for p in payloads if "sampling" not in p][:SERVE["f32_requests"]]
    try:
        results = _submit_all(loop, greedy)
    finally:
        loop.drain(60)
    checked, ties, worst_gap = 0, 0, 0.0
    for p, (res, _, _) in zip(greedy, results):
        toks = res["tokens"]
        seq = np.concatenate([p["tokens"], np.asarray(toks[:-1], np.int32)])
        with torch.no_grad():
            logits = decoder.module(torch.from_numpy(seq)[None].to(DEVICE).long())[0]
        plen = len(p["tokens"])
        rows = logits[plen - 1:plen - 1 + len(toks)]
        full = rows.argmax(-1).tolist()
        for t, (a, b) in enumerate(zip(toks, full)):
            checked += 1
            if a == b:
                continue
            gap = float(rows[t, b] - rows[t, a])
            worst_gap = max(worst_gap, gap)
            if gap > SERVE_F32_TIE_ATOL:
                raise AssertionError(
                    f"float32 paged token {a} != full-forward argmax {b} at step {t} "
                    f"(logit gap {gap:.3e})")
            ties += 1
    del decoder, loop
    torch.cuda.empty_cache()
    return {"tokens_checked": checked, "near_ties": ties, "worst_tie_gap": worst_gap}


def _run_each(calls):
    """Run the thunks at once; (the result, or the exception raised,
    start time, end time) of each, in order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(call):
        t0 = time.perf_counter()
        try:
            res = call()
        except Exception as e:  # noqa: BLE001 — the caller types it
            res = e
        return res, t0, time.perf_counter()

    with ThreadPoolExecutor(len(calls)) as ex:
        return [f.result() for f in [ex.submit(one, c) for c in calls]]


def _results(runs, what):
    """The results of ``_run_each``; raises on the first exception."""
    for i, (res, _, _) in enumerate(runs):
        if isinstance(res, Exception):
            raise AssertionError(f"{what}: request {i} raised {res!r}") from res
    return [res for res, _, _ in runs]


def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.001)
    return True


def phase_disagg(torch, kernel_modules):
    """Disaggregated serving, the host and peer KV tiers and fault
    containment across GPT-2-small replicas of ``server.serve`` (phase 19
    of the docstring). Every check that fails is listed, after the one
    ``disagg:`` line of numbers."""
    from tfk8s_tpu_torch.runtime import server
    from tfk8s_tpu_torch.utils.logging import Metrics

    t_phase = time.perf_counter()
    metrics = Metrics()
    server.set_metrics(metrics)
    for mod in kernel_modules:
        mod.reset_launches()
    env = dict(SERVE_ENV, TFK8S_DEVICE=DEVICE)
    envs = [
        dict(env, TFK8S_POD_NAME="chip-smoke-prefill", TFK8S_SERVE_PHASE="prefill",
             TFK8S_KV_PEER_FETCH="1"),
        dict(env, TFK8S_POD_NAME="chip-smoke-decode", TFK8S_SERVE_PHASE="decode",
             TFK8S_SERVE_PREFIX_CACHE="0"),
        dict(env, TFK8S_POD_NAME="chip-smoke-host",
             TFK8S_SERVE_MAX_PAGES=str(DISAGG["host_pages"]),
             TFK8S_KV_HOST_BYTES=str(DISAGG["host_bytes"])),
    ]
    t_load = time.perf_counter()
    replicas = _run_serves(server, envs)
    out = {"load_s": time.perf_counter() - t_load}
    (pre, *_), (dec, _, dec_thread, dec_errors), (host, *_) = replicas
    failures = []
    try:
        out["handoff"] = _disagg_handoff(torch, metrics, pre, dec, failures)
        out["host"], a, want_a = _disagg_host(metrics, host, failures)
        out["peer"] = _disagg_peer(server, metrics, pre, a, want_a, failures)
        out["containment"] = _disagg_contain(server, dec, dec_thread, dec_errors, failures)
    finally:
        for _, stop, _, _ in replicas:
            stop.set()
        for _, _, thread, _ in replicas:
            thread.join(timeout=120)
        server.unregister_replica(f"default/{envs[1]['TFK8S_POD_NAME']}")  # the corpse's entry
    for (_, _, thread, errors), env_ in ((replicas[0], envs[0]), (replicas[2], envs[2])):
        if errors or thread.is_alive():
            failures.append(f"{env_['TFK8S_POD_NAME']} did not exit cleanly: {errors}")
    out["kernel_launches"] = {k: v for mod in kernel_modules for k, v in mod.LAUNCHES.items()}
    if any(out["kernel_launches"].values()):
        failures.append(f"the disaggregated path launched port kernels: {out['kernel_launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    if out["phase_s"] > DISAGG["limit_s"]:
        failures.append(f"the phase took {out['phase_s']:.1f} s, over {DISAGG['limit_s']} s")
    log(f"disagg: {json.dumps(out)}")
    if failures:
        raise AssertionError("; ".join(failures))


def _disagg_handoff(torch, metrics, pre, dec, failures):
    """(a): SERVE's requests, colocated on the decode replica, then
    prefilled on the prefill replica, moved over the wire and decoded
    from the buffer."""
    import dataclasses

    import numpy as np

    from tfk8s_tpu_torch.runtime.handoff import LocalKVTransport

    transport, tmo = LocalKVTransport(), SERVE["timeout_s"]
    payloads = _serve_requests(SERVE["requests"], dec.model.vocab_size)

    def handoffs(bufs):
        return _results(_run_each([
            lambda b=b, p=p: dec.submit_handoff(b, timeout=tmo, sampling=p.get("sampling"))
            for b, p in zip(bufs, payloads)]), "submit_handoff")

    def counter(name, replica):
        return metrics.get_counter(name, replica.labels) or 0.0

    colocated = _results(_run_each([lambda p=p: dec.submit(p, timeout=tmo) for p in payloads]),
                         "colocated submit")
    want = [r["tokens"] for r in colocated]
    exports0 = counter("tfk8s_disagg_exports_total", pre)
    imports0 = counter("tfk8s_disagg_imports_total", dec)
    prefilled = _results(_run_each([lambda p=p: pre.submit_prefill(p, timeout=tmo)
                                    for p in payloads]), "submit_prefill")
    moved, rows = [], []
    for res in prefilled:
        t0 = time.perf_counter()
        buf, nbytes = transport.transfer(res["handoff"])
        rows.append({"wire_bytes": nbytes, "transfer_ms": (time.perf_counter() - t0) * 1e3})
        moved.append(buf)
    handed = handoffs(moved)
    exports = counter("tfk8s_disagg_exports_total", pre) - exports0
    imports = counter("tfk8s_disagg_imports_total", dec) - imports0
    # the time to the first decode token: each buffer again as a handoff
    # of one decode step, one at a time
    probe_off = []
    for i, (buf, p, res, row) in enumerate(zip(moved, payloads, prefilled, rows)):
        t0 = time.perf_counter()
        got = dec.submit_handoff(dataclasses.replace(buf, gen_budget=2), timeout=tmo,
                                 sampling=p.get("sampling"))["tokens"]
        probe_ms = (time.perf_counter() - t0) * 1e3
        if got != want[i][:2]:
            probe_off.append(i)
        row.update(colocated_ttft_ms=colocated[i]["ttft_s"] * 1e3,
                   prefill_ttft_ms=res["ttft_s"] * 1e3,
                   import_wait_ms=handed[i]["ttft_s"] * 1e3, one_step_handoff_ms=probe_ms,
                   first_decode_ms=res["ttft_s"] * 1e3 + row["transfer_ms"] + probe_ms)
    # planted: layer 0's K rows zeroed in the moved buffers
    n = DISAGG["fault_requests"]
    planted = handoffs([dataclasses.replace(b, kv=[torch.zeros_like(b.kv[0]), *b.kv[1:]])
                        for b in moved[:n]])
    first_off = [i for i, (r, w) in enumerate(zip(prefilled, want)) if r["tokens"] != w[:1]]
    differ = [i for i, (r, w) in enumerate(zip(handed, want)) if r["tokens"] != w]
    planted_differ = sum(r["tokens"] != w for r, w in zip(planted, want))
    for bad, what in ((first_off, "prefill token != want[0]"), (differ, "handoff != colocated"),
                      (probe_off, "one-step handoff != want[:2]")):
        if bad:
            failures.append(f"(a) requests {bad}: {what}")
    if (exports, imports) != (len(payloads), len(payloads)):
        failures.append(f"(a) exports {exports}, imports {imports}, want {len(payloads)} each")
    if planted_differ < 1:
        failures.append("(a) zeroed layer-0 K rows changed no stream: the check cannot fail")
    keys = ("colocated_ttft_ms", "prefill_ttft_ms", "transfer_ms", "import_wait_ms",
            "one_step_handoff_ms", "first_decode_ms", "wire_bytes")
    return {
        "requests": len(payloads), "gen_tokens": SERVE["gen"],
        "exact": len(payloads) - len(differ), "first_token_exact": len(payloads) - len(first_off),
        "exports": exports, "imports": imports,
        "planted_layer0_k_zeroed": {"requests": n, "differ": planted_differ},
        "median": {k: float(np.median([row[k] for row in rows])) for k in keys},
        "per_request": rows,
    }


def _disagg_host(metrics, host, failures):
    """(b): a prompt's pages demoted to host memory by other prompts and
    restored, then its host entry corrupted. Returns (the numbers, the
    prompt, its tokens)."""
    import numpy as np

    from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

    rng = np.random.default_rng(DISAGG["seed"])
    vocab, ps, tmo = host.model.vocab_size, host.model.page_size, SERVE["timeout_s"]

    def prompt():
        return {"tokens": rng.integers(1, vocab, DISAGG["host_prompt"]).astype(np.int32),
                "gen_tokens": DISAGG["host_gen"]}

    def ops(op):
        return metrics.get_counter("tfk8s_serving_kv_host_ops_total",
                                   {**host.labels, "op": op}) or 0.0

    def churn():
        for _ in range(DISAGG["host_churn"]):
            host.submit(prompt(), timeout=tmo)
        return len(host.allocator.cached_chain(chain))

    a = prompt()
    chain = prefix_digest_chain(a["tokens"], ps, (len(a["tokens"]) - 1) // ps)
    cold = host.submit(a, timeout=tmo)
    want = cold["tokens"]
    resident = churn()
    parked = sum(host._kv_host.has(d) for d in chain)
    warm = host.submit(a, timeout=tmo)
    demotes, restores, failed = ops("demote"), ops("restore"), ops("restore_failed")
    restore_ms = list(host._kv_restore_ms)
    # planted: demoted again, its host entries' bytes flipped under their
    # demotion-time checksums
    resident_again = churn()
    tampered = 0
    for d in chain:
        entry = host._kv_host._entries.get(d)
        if entry is not None:
            wire, akey, checksum = entry
            host._kv_host._entries[d] = (wire[:-3] + b"\xff\xff\xff", akey, checksum)
            tampered += 1
    again = host.submit(a, timeout=tmo)
    failed_after = ops("restore_failed")
    if resident or resident_again:
        failures.append(f"(b) the prompt kept {resident}/{resident_again} pages on the device")
    if not parked or demotes < 1 or restores < 1 or failed:
        failures.append(f"(b) host entries {parked}, demote {demotes}, restore {restores}, "
                        f"restore_failed {failed}")
    if warm["tokens"] != want:
        failures.append("(b) the restored prompt's tokens differ")
    if not tampered or failed_after != failed + 1 or again["tokens"] != want:
        failures.append(f"(b) corrupt entry: {tampered} tampered, restore_failed "
                        f"{failed_after}, tokens equal {again['tokens'] == want}")
    return {
        "prompt": len(a["tokens"]), "gen_tokens": DISAGG["host_gen"], "pages": DISAGG["host_pages"],
        "chain_pages": len(chain), "demote": demotes, "restore": restores,
        "restore_failed_after_corruption": failed_after, "restore_ms": restore_ms,
        "ttft_ms": {"cold": cold["ttft_s"] * 1e3, "restored": warm["ttft_s"] * 1e3,
                    "corrupt_fallback": again["ttft_s"] * 1e3},
        "host": host._kv_host.stats(),
    }, a, want


def _disagg_peer(server, metrics, pre, a, want, failures):
    """(c): the prefill replica pulls (b)'s prompt from the host-tier
    replica by ``kv_peer``."""
    from tfk8s_tpu_torch.runtime import kvtier

    peer = "default/chip-smoke-host"
    labels = {**pre.labels, "outcome": "ok"}
    t0 = time.perf_counter()
    buf = kvtier.fetch_prefix(server.lookup_replica, peer, a["tokens"])
    fetch_ms = (time.perf_counter() - t0) * 1e3
    ok0 = metrics.get_counter("tfk8s_serving_kv_peer_fetches_total", labels) or 0.0
    hits0 = pre.allocator.prefix_hits
    got = pre.submit(a, timeout=SERVE["timeout_s"], kv_peer=peer)
    ok = (metrics.get_counter("tfk8s_serving_kv_peer_fetches_total", labels) or 0.0) - ok0
    if ok != 1 or pre.allocator.prefix_hits != hits0 + 1 or got["tokens"] != want:
        failures.append(f"(c) peer fetches ok {ok}, hits {pre.allocator.prefix_hits - hits0}, "
                        f"tokens equal {got['tokens'] == want}")
    return {"fetch_ms": fetch_ms, "pages": buf.n_pages, "wire_bytes": len(buf.to_bytes()),
            "ok": ok, "ttft_ms": got["ttft_s"] * 1e3}


def _disagg_contain(server, dec, thread, errors, failures):
    """(d): one poisoned row among DISAGG["contain_requests"], then the
    decode replica crashed under an in-flight request."""
    from concurrent.futures import ThreadPoolExecutor

    n, v, tmo = DISAGG["contain_requests"], DISAGG["poisoned"], SERVE["timeout_s"]
    kill = "chaos: chip smoke kill"
    payloads = [dict(p, gen_tokens=DISAGG["contain_gen"])
                for p in _serve_requests(n, dec.model.vocab_size)]

    def batch():
        return _run_each([lambda p=p: dec.submit(p, timeout=tmo) for p in payloads])

    clean = [r["tokens"] for r in _results(batch(), "clean batch")]
    alloc = dec.allocator
    held0 = alloc.quarantined_pages
    dec.chaos_poison_row(payloads[v]["tokens"])
    poisoned = [r for r, _, _ in batch()]
    errs = {i: r for i, r in enumerate(poisoned) if isinstance(r, Exception)}
    exact = sum(not isinstance(r, Exception) and r["tokens"] == clean[i]
                for i, r in enumerate(poisoned) if i != v)
    held = alloc.quarantined_pages - held0
    frozen = set(alloc._quarantined)
    again = [r["tokens"] for r in _results(batch(), "batch after the fault")]
    kept = set(alloc._quarantined) == frozen and not frozen & set(alloc._free)
    verified = alloc.verify_quarantined()
    if set(errs) != {v} or not isinstance(errs[v], server.RowFault):
        failures.append(f"(d) errors {errs!r}, want RowFault on request {v} alone")
    if exact != n - 1 or again != clean:
        failures.append(f"(d) {exact} of {n - 1} siblings exact; the next batch equal "
                        f"{again == clean}")
    if held < 1 or not kept or verified < held:
        failures.append(f"(d) quarantined {held}, kept through a batch {kept}, verified {verified}")
    # the crash: an in-flight request, the replica's serve() thread
    with ThreadPoolExecutor(1) as ex:
        inflight = ex.submit(dec.submit, dict(payloads[0], gen_tokens=SERVE["gen"]), tmo)
        live = _wait_until(lambda: dec.live_slots >= 1)
        crashed = server.chaos_crash_replica(f"default/{dec.labels['pod']}", message=kill)
        lost = inflight.exception(timeout=60)
    thread.join(timeout=30)
    ready = dec.report_progress()["serving_ready"]
    try:
        dec.submit(payloads[0], timeout=5)
        refused = None
    except Exception as e:  # noqa: BLE001
        refused = e
    ended = errors[0] if errors and not thread.is_alive() else None
    if not (live and crashed and isinstance(lost, server.ReplicaUnavailable) and kill in str(lost)
            and isinstance(refused, server.ReplicaUnavailable) and ready == 0.0
            and isinstance(ended, server.ServeError) and f"replica fault: {kill}" in str(ended)):
        failures.append(f"(d) crash: live {live}, crashed {crashed}, in-flight {lost!r}, "
                        f"after {refused!r}, ready {ready}, serve ended {ended!r}")
    return {"requests": n, "gen_tokens": DISAGG["contain_gen"], "poisoned": v,
            "row_fault": type(errs.get(v)).__name__, "siblings_exact": exact,
            "quarantined_pages": held, "verified_pages": verified,
            "crash": {"in_flight": type(lost).__name__, "after": type(refused).__name__,
                      "serving_ready": ready, "serve_ended": str(ended)}}



def _batch_hash(batch):
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()[:16]


GANG_WORKER = r"""
import hashlib, json, os, sys, time
T0 = time.perf_counter()
sys.path.insert(0, os.environ["CHIP_SMOKE_ROOT"])
import numpy as np
import torch

from tfk8s_tpu_torch.models import gpt
from tfk8s_tpu_torch.ops import flash_attention as fa
from tfk8s_tpu_torch.parallel.data_parallel import DataParallel
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.launcher import ProcessContext, initialize_distributed

env = dict(os.environ)
# two ranks share one card: gloo, as NCCL will not put them on one device
initialize_distributed(ProcessContext.from_env(env), env, backend="gloo")
ctx, dev = ttrain.join_job(env)
preset = gpt.tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else gpt.base_config
cfg = preset(attention_impl="flash", num_layers=int(env["GANG_LAYERS"]))
task = gpt.task_for_mesh(dev, cfg=cfg, seq_len=int(env["TFK8S_SEQ_LEN"]),
                         batch_size=int(env["TFK8S_BATCH_SIZE"]))
trainer = ttrain.Trainer(task, ttrain.config_from_env(env, ctx), dev, DataParallel(ctx.mesh, dev))
fa.reset_launches()
t_fit = time.perf_counter()
state, hist = trainer.fit()
if dev.type == "cuda":
    torch.cuda.synchronize()
fit_s = time.perf_counter() - t_fit
lo, hi, n = trainer.input_shard_range
hashes = {f"{step} {s}": None for step in range(state.step) for s in range(lo, hi)}
for key in hashes:
    step, s = map(int, key.split())
    shard = trainer._make_shard_batch(step, s, s + 1, n)
    h = hashlib.sha256()
    for k in sorted(shard):
        h.update(np.ascontiguousarray(shard[k]).tobytes())
    hashes[key] = h.hexdigest()[:16]
model = state.state_dict()["model"]
checksum = sum(float(t.double().abs().sum()) for t in model.values())
print("RANK " + json.dumps({
    "rank": trainer.parallel.rank, "mode": trainer.parallel.mode, "shards": [lo, hi, n],
    "losses": [h["loss"] for h in hist], "steps_per_s": hist[-1]["steps_per_s"],
    "step_s": [h["step"] / h["steps_per_s"] for h in hist],
    "checksum": repr(checksum), "hashes": hashes, "launches": dict(fa.LAUNCHES),
    "started_s": t_fit - T0, "fit_s": fit_s, "run_s": time.perf_counter() - T0}), flush=True)
"""


def _run_gang(n_procs, env):
    """``n_procs`` processes of GANG_WORKER joined on a free port; their
    RANK records in rank order. A process past DIST's timeout, or one that
    fails, fails the phase after the whole gang is killed."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(n_procs):
        penv = dict(os.environ, **env, CHIP_SMOKE_ROOT=root, TFK8S_DISTRIBUTED="1",
                    TFK8S_NUM_PROCESSES=str(n_procs), TFK8S_PROCESS_ID=str(rank),
                    TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        if DEVICE == "cpu":
            penv["TFK8S_DEVICE"] = "cpu"
        procs.append(subprocess.Popen([sys.executable, "-c", GANG_WORKER], env=penv, cwd=root,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST["timeout_s"])[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"gang of {n_procs} ran past {DIST['timeout_s']} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"gang rank {rank} exited {p.returncode}:\n{out[-3000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if len(lines) != 1:
            raise AssertionError(f"gang rank {rank} printed no result:\n{out[-3000:]}")
        records.append(json.loads(lines[0][5:]))
    return sorted(records, key=lambda r: r["rank"])


def phase_distributed(torch, gpt, fa, root):
    """Record-file input, a two-rank gloo gang on the one card, elastic
    resume and the Evaluator at GPT-2-small base width (docstring phase
    11). Returns the launches of the paths it drives in this process."""
    import numpy as np

    from tfk8s_tpu_torch.data import _native, example
    from tfk8s_tpu_torch.data.dataset import RecordDataset
    from tfk8s_tpu_torch.data.recordio import RecordWriter
    from tfk8s_tpu_torch.parallel.data_parallel import DataParallel
    from tfk8s_tpu_torch.runtime import progress
    from tfk8s_tpu_torch.runtime import train as ttrain
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    card = phase_card()
    d = DIST
    work = os.path.join(root, "build", "chip_smoke_dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tiny = TRAIN_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    cfg = (gpt.tiny_config if tiny else gpt.base_config)(attention_impl="flash")
    layers, seq, batch = cfg.num_layers, int(TRAIN_ENV["TFK8S_SEQ_LEN"]), 8
    # the gang, the one-process run it is held to and the resume: GANG_LAYERS
    gang_cfg = dataclasses.replace(cfg, num_layers=GANG_LAYERS)
    total = dict.fromkeys(fa.KERNELS, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # 1. the shards, through the native record core
    if _native.load() is None:
        raise AssertionError("the native record core did not load")
    make = gpt.make_batch_fn(cfg.vocab_size, seq)
    rng = np.random.default_rng(d["seed"])
    t0 = time.perf_counter()
    nbytes = 0
    shards = [(f"train-{i}.rio", d["records_per_file"]) for i in range(d["train_files"])]
    for name, count in shards + [("eval-0.rio", d["eval_records"])]:
        rows = make(rng, count)["input"]
        with RecordWriter(os.path.join(work, name)) as w:
            for row in rows:
                rec = example.encode({"input": row})
                nbytes += len(rec)
                w.write(rec)
    write_s = time.perf_counter() - t0
    log(f"distributed shards: {json.dumps({'card': card, 'bytes': nbytes, 'write_s': write_s, 'write_mb_per_s': nbytes / write_s / 1e6})}")
    files = os.path.join(work, "train-*.rio")

    # 2. gpt:train from the shards, one process
    ckpt = os.path.join(work, "ckpt_files")
    env = dict(TRAIN_ENV, TFK8S_INPUT_FILES=files, TFK8S_BATCH_SIZE=str(batch),
               TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_SEED=str(d["seed"]))
    if DEVICE == "cpu":
        env["TFK8S_DEVICE"] = "cpu"
    first = []
    to_device = ttrain.Trainer.to_device

    def spy(self, host):
        if not first:
            first.append(_batch_hash(host))
        return to_device(self, host)

    ttrain.Trainer.to_device = spy
    progress.clear()
    fa.reset_launches()
    try:
        history = gpt.train(env)
    finally:
        ttrain.Trainer.to_device = to_device
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    add(launches)
    report = progress.snapshot()
    want_first = _batch_hash(next(RecordDataset(
        sorted(glob.glob(files)), batch_size=batch, seed=d["seed"]).batches(0)))
    losses = [h["loss"] for h in history]
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"])
    latest = Checkpointer(ckpt).latest_step()
    log(f"distributed files: {json.dumps({'card': card, 'steps': len(losses), 'step_ms': step_s * 1e3, 'tokens_per_s': batch * seq / step_s, 'first_step_s': t_first, 'input_wait_s': report.get('input_wait_seconds'), 'input_starved_steps': report.get('input_starved_steps'), 'first_batch': first, 'dataset_first_batch': want_first, 'losses': losses, 'latest_step': latest, 'launches': launches})}")
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * TRAIN_STEPS)}
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"files run: losses {losses}")
    if launches != want:
        raise AssertionError(f"files run: flash launches {launches}, want {want}")
    if first != [want_first]:
        raise AssertionError(f"files run: first batch {first}, dataset's {want_first}")
    if latest != TRAIN_STEPS:
        raise AssertionError(f"files run: latest committed step {latest}")

    # 3. a two-rank gang on the one card against one process, then resume
    torch.cuda.empty_cache()
    gang_ckpt = os.path.join(work, "ckpt_gang")
    gang_env = dict(TRAIN_ENV, TFK8S_BATCH_SIZE=str(batch), TFK8S_MESH='{"data": 2}',
                    GANG_LAYERS=str(GANG_LAYERS),
                    TFK8S_INPUT_MODE="per_host", TFK8S_INPUT_SHARDS="2",
                    TFK8S_TRAIN_STEPS=str(d["gang_steps"]),
                    TFK8S_CHECKPOINT_EVERY=str(d["gang_steps"]),
                    TFK8S_CHECKPOINT_DIR=gang_ckpt)
    t0 = time.perf_counter()
    ranks = _run_gang(2, gang_env)
    gang_s = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    single_cfg = ttrain.TrainConfig(
        steps=d["resume_steps"], learning_rate=float(TRAIN_ENV["TFK8S_LEARNING_RATE"]),
        log_every=1, input_mode="per_host", input_shards=2)
    trainer = ttrain.Trainer(gpt.task_for_mesh(dev, cfg=gang_cfg, seq_len=seq, batch_size=batch),
                             single_cfg, dev, DataParallel(None, dev))
    fa.reset_launches()
    _, single = trainer.fit()
    torch.cuda.synchronize()
    add(fa.LAUNCHES)
    single_losses = [h["loss"] for h in single]
    single_hashes = {f"{step} {s}": _batch_hash(trainer._make_shard_batch(step, s, s + 1, 2))
                     for step in range(d["gang_steps"]) for s in range(2)}
    gang_hashes = {**ranks[0]["hashes"], **ranks[1]["hashes"]}
    resume_env = dict(gang_env, TFK8S_TRAIN_STEPS=str(d["resume_steps"]), TFK8S_WORLD_VERSION="1",
                      TFK8S_CHECKPOINT_EVERY="0")
    del resume_env["TFK8S_MESH"]
    if DEVICE == "cpu":
        resume_env["TFK8S_DEVICE"] = "cpu"
    fa.reset_launches()
    with gang_depth(GANG_LAYERS):
        resumed = gpt.train(resume_env)
    torch.cuda.synchronize()
    add(fa.LAUNCHES)
    resumed_losses = [h["loss"] for h in resumed]
    gang_err = max(abs(a - b) for a, b in zip(ranks[0]["losses"], single_losses))
    resume_err = max(abs(a - b) for a, b in zip(resumed_losses, single_losses[d["gang_steps"]:]))
    s_first = single[0]["step"] / single[0]["steps_per_s"]
    s_last = single[-1]["step"] / single[-1]["steps_per_s"]
    single_step_ms = (s_last - s_first) / (single[-1]["step"] - single[0]["step"]) * 1e3
    g_times = ranks[0]["step_s"]
    gang_step_ms = (g_times[-1] - g_times[0]) / (len(g_times) - 1) * 1e3
    log(f"distributed gang: {json.dumps({'card': card, 'ranks': 2, 'backend': 'gloo', 'mode': ranks[0]['mode'], 'shards': [r['shards'] for r in ranks], 'gang_wall_s': gang_s, 'gang_step_ms': gang_step_ms, 'one_process_step_ms': single_step_ms, 'gang_losses': ranks[0]['losses'], 'one_process_losses': single_losses, 'gang_max_err': gang_err, 'checksums': [r['checksum'] for r in ranks], 'resumed_losses': resumed_losses, 'resume_max_err': resume_err, 'rank_launches': [r['launches'] for r in ranks], 'rank_timing_s': [{k: r[k] for k in ('started_s', 'fit_s', 'run_s')} for r in ranks]})}")
    if [r["shards"] for r in ranks] != [[0, 1, 2], [1, 2, 2]]:
        raise AssertionError(f"gang shards {[r['shards'] for r in ranks]}")
    if gang_hashes != single_hashes:
        raise AssertionError(f"gang shard hashes {gang_hashes} != one process's {single_hashes}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("the gang's ranks disagree on the losses")
    if ranks[0]["checksum"] != ranks[1]["checksum"]:
        raise AssertionError("the gang's ranks end with different parameters")
    if not gang_err <= DIST_LOSS_ATOL:
        raise AssertionError(f"gang losses {gang_err:.3e} from one process's")
    want_gang = GANG_LAYERS * d["gang_steps"]
    for r in ranks:
        if any(r["launches"][k] != want_gang for k in fa.TENSOR_CORE_KERNELS):
            raise AssertionError(f"rank {r['rank']} flash launches {r['launches']}")
    if [h["step"] for h in resumed] != list(range(d["gang_steps"] + 1, d["resume_steps"] + 1)):
        raise AssertionError(f"resume ran steps {[h['step'] for h in resumed]}")
    if not resume_err <= DIST_LOSS_ATOL:
        raise AssertionError(f"resumed losses {resume_err:.3e} from the uninterrupted run's")

    # 4. the Evaluator on the files run's final checkpoint
    eval_env = {"TFK8S_CHECKPOINT_DIR": ckpt, "TFK8S_TRAIN_STEPS": str(TRAIN_STEPS),
                "TFK8S_EVAL_TIMEOUT": "60", "TFK8S_EVAL_BATCHES": str(d["eval_batches"]),
                "TFK8S_EVAL_INPUT_FILES": os.path.join(work, "eval-*.rio")}
    if DEVICE == "cpu":
        eval_env["TFK8S_DEVICE"] = "cpu"
    task = gpt.task_for_mesh(dev, cfg=cfg, seq_len=seq, batch_size=batch)
    fa.reset_launches()
    t0 = time.perf_counter()
    metrics = ttrain.run_eval(task, eval_env)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    add(launches)
    plain = gpt.make_task(cfg, seq_len=seq, batch_size=batch).init(torch.Generator().manual_seed(0))
    plain.load_state_dict(Checkpointer(ckpt).restore(TRAIN_STEPS)["model"])
    plain = plain.to(dev)
    for layer in plain.layers:
        layer.attn.attn_fn = None
    eval_ds = RecordDataset(glob.glob(eval_env["TFK8S_EVAL_INPUT_FILES"]), batch_size=batch,
                            shuffle=False)
    with torch.no_grad():
        plain_losses = [
            float(gpt.lm_loss_and_metrics(plain(ids), ids)[0])
            for ids in (torch.from_numpy(b["input"]).to(dev)
                        for b, _ in zip(eval_ds.batches(0), range(d["eval_batches"])))]
    plain_loss = sum(plain_losses) / len(plain_losses)
    eval_err = abs(metrics.get("loss", math.nan) - plain_loss)
    log(f"distributed eval: {json.dumps({'card': card, 'eval_s': eval_s, 'metrics': metrics, 'plain_loss': plain_loss, 'err': eval_err, 'launches': launches})}")
    if metrics.get("step") != float(TRAIN_STEPS) or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"eval metrics {metrics}")
    if not eval_err <= DIST_LOSS_ATOL:
        raise AssertionError(f"eval loss {eval_err:.3e} from plain attention's")
    n_eval = min(d["eval_batches"], d["eval_records"] // batch)
    want_eval = {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd_wgmma": layers * n_eval}
    if launches != want_eval:
        raise AssertionError(f"eval flash launches {launches}, want {want_eval}")
    shutil.rmtree(work, ignore_errors=True)
    return total


def _attn_impl(torch, model, fn):
    """Point every attention of ``model`` at ``fn`` (None: plain)."""
    from tfk8s_tpu_torch.models.transformer import MultiHeadAttention

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_fn = fn


def _loss_and_grads(torch, loss_fn, model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()}


def _grads_rel_l2(grads, want):
    num = sum(float((grads[n] - want[n]).square().sum()) for n in want)
    return math.sqrt(num / sum(float(want[n].square().sum()) for n in want))


def _t5_padded(batch, seed):
    """The reversal batch with each source's last quarter to half set to
    PAD_ID (targets the reversed sources, so they start with pads)."""
    import numpy as np

    from tfk8s_tpu_torch.models import t5

    rng = np.random.default_rng(seed)
    src = batch["src"].copy()
    b, l = src.shape
    for row in src:
        row[l - rng.integers(l // 4, l // 2 + 1):] = t5.PAD_ID
    tgt = np.ascontiguousarray(src[:, ::-1])
    tgt_in = np.concatenate([np.full((b, 1), t5.BOS_ID, np.int32), tgt[:, :-1]], 1)
    return {"src": src, "tgt_in": tgt_in.astype(np.int32), "tgt_out": tgt}


def _device(torch, batch):
    import numpy as np

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEVICE) for k, v in batch.items()}


def _family_task(name, module, cfg, batch, attn_fn=None):
    e = FAMILIES[name]["env"]
    if name == "vit":
        return module.make_task(cfg, num_classes=int(e["TFK8S_NUM_CLASSES"]),
                                image_size=int(e["TFK8S_IMAGE_SIZE"]),
                                patch_size=int(e["TFK8S_PATCH_SIZE"]), batch_size=batch,
                                attn_fn=attn_fn)
    return module.make_task(cfg, seq_len=int(e["TFK8S_SEQ_LEN"]), batch_size=batch,
                            attn_fn=attn_fn)


def _family_check(torch, fa, name, module):
    """Base-width bf16 loss and gradients, flash against plain attention,
    on one batch (and, for T5, on a padded one), with the planted fault of
    the family where it has one. Returns the numbers; raises on a miss."""
    import numpy as np

    c = FAMILY_CHECK
    batch_size = c["vit_batch"] if name == "vit" else c["batch"]
    task = _family_task(name, module, module.base_config(), batch_size)
    model = task.init(torch.Generator().manual_seed(1)).to(DEVICE)
    host = task.make_batch(np.random.default_rng(c["seed"]), batch_size)
    batches = {"batch": host}
    if name == "t5":
        batches["padded"] = _t5_padded(host, c["seed"])
    fault = {
        "bert": ("causal", lambda q, k, v, mask=None, causal=False:
                 fa.flash_attention(q, k, v, mask, causal=True)),
        "t5": ("mask_dropped", lambda q, k, v, mask=None, causal=False:
               fa.flash_attention(q, k, v, None, causal)),
    }.get(name)
    out = {}
    for kind, hb in batches.items():
        batch = _device(torch, hb)
        loss_full, g_full = _loss_and_grads(torch, task.loss_fn, model, batch)
        runs = {"flash": fa.flash_attention}
        if fault and (name == "bert" or kind == "padded"):
            runs[f"fault_{fault[0]}"] = fault[1]
        res = {}
        for impl, fn in runs.items():
            _attn_impl(torch, model, fn)
            try:
                loss, grads = _loss_and_grads(torch, task.loss_fn, model, batch)
            finally:
                _attn_impl(torch, model, None)
            res[impl] = {"loss_err": abs(loss - loss_full),
                         "grad_rel_l2": _grads_rel_l2(grads, g_full),
                         "finite": bool(math.isfinite(loss))}
            del grads
        out[kind] = {"loss_full": loss_full, **res}
        del g_full
        for impl, r in res.items():
            within = r["finite"] and r["loss_err"] <= BF16_ATOL and \
                r["grad_rel_l2"] <= FAMILY_GRAD_REL_L2
            if impl == "flash" and not within:
                raise AssertionError(f"{name} {kind}: flash vs plain {r} beyond loss atol "
                                     f"{BF16_ATOL} / grad rel L2 {FAMILY_GRAD_REL_L2}")
            if impl != "flash" and within:
                raise AssertionError(f"{name} {kind}: the planted fault {impl} {r} passes")
    del model
    torch.cuda.empty_cache()
    return out


def _family_f32(torch, fa, name, module):
    """A small float32 config (TF32 off) through the kernels on the card
    against the same model through the plain versions on the CPU: loss and
    every gradient within F32_GRAD_ATOL. T5 on a padded batch, ViT at 49
    patches (a ragged length)."""
    import copy

    import numpy as np

    small = dict(dtype=torch.float32, embed_dim=64, num_heads=2, head_dim=32, mlp_dim=128,
                 num_layers=2)
    if name == "vit":
        cfg = module.tiny_config(**small)
        task = module.make_task(cfg, num_classes=8, image_size=28, patch_size=4, batch_size=2,
                                attn_fn=fa.flash_attention)
    else:
        cfg = module.tiny_config(vocab_size=256, max_len=128, **small)
        task = module.make_task(cfg, seq_len=96, batch_size=2, attn_fn=fa.flash_attention)
    host = task.make_batch(np.random.default_rng(5), 2)
    if name == "t5":
        host = _t5_padded(host, 5)
    cpu = task.init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(DEVICE)
    results = []
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        loss, grads = _loss_and_grads(torch, task.loss_fn, model, batch)
        results.append((loss, {n: g.cpu() for n, g in grads.items()}))
    l_err = abs(results[0][0] - results[1][0])
    g_err = max(float((results[0][1][n] - results[1][1][n]).abs().max()) for n in results[0][1])
    if not (l_err <= F32_GRAD_ATOL and g_err <= F32_GRAD_ATOL):
        raise AssertionError(f"{name} f32: card kernels vs CPU plain: loss {l_err:.2e}, "
                             f"grads {g_err:.2e} (atol {F32_GRAD_ATOL})")
    return {"loss_err": l_err, "max_grad_err": g_err}


def _staged_step(torch, task, steps):
    """A train step of the port's ``Trainer`` on batches staged on the card
    (CUDA events over ``steps`` steps), and one step's profiler trace: the
    card's busy time, its idle share of the step, the kernels that take
    most of it (and the optimizer's device-side range),
    and the ``[b, l]``-shaped ``aten::_to_copy`` calls (the flash wrappers'
    mask conversions, with the loss's target cast) with their device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tfk8s_tpu_torch.runtime.train import TrainConfig, Trainer
    from tfk8s_tpu_torch.tools.gn_sweep import events_ms

    trainer = Trainer(task, TrainConfig(steps=10 ** 6, learning_rate=1e-4), DEVICE)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    staged = [trainer.to_device(task.make_batch(rng, task.batch_size)) for _ in range(2)]
    i = [0]

    def step():
        trainer.train_step(state, staged[i[0] % 2])
        i[0] += 1

    ms = events_ms(step, steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n_act = _device_busy_ms(torch, prof)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() * 1e-3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    lead = next(iter(staged[0].values())).shape[:2]
    copies, copy_ms = 0, 0.0
    for row in prof.key_averages(group_by_input_shape=True):
        if row.key == "aten::_to_copy" and row.input_shapes and \
                list(row.input_shapes[0]) == list(lead):
            copies += row.count
            copy_ms += (getattr(row, "device_time_total", None)
                        or getattr(row, "cuda_time_total", 0.0)) * 1e-3
    del state, trainer, staged
    torch.cuda.empty_cache()
    # the profiler slows the host, so the idle share is taken against the
    # unprofiled step time
    return {"staged_step_ms": ms, "profiled_step_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / ms, "device_activities": n_act,
            "top_kernels": [{"name": k[:90], "ms": t, "count": n} for k, (t, n) in top],
            f"to_copy_{list(lead)}_calls": copies, f"to_copy_{list(lead)}_device_ms": copy_ms}


def _family_train(torch, fa, name, module):
    """``<family>:train(env)`` at base width: finite losses and each
    tensor-core flash kernel launched sites x steps times (the CUDA-core
    ones never). Returns (summary, launches)."""
    from tfk8s_tpu_torch.runtime import progress

    f = FAMILIES[name]
    env = dict(FAMILY_ENV, **f["env"])
    steps = int(env["TFK8S_TRAIN_STEPS"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    progress.clear()
    fa.reset_launches()
    t0 = time.perf_counter()
    history = module.train(env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prog = progress.snapshot()
    losses = [h["loss"] for h in history]
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"])
    unit, per_step = f["per_step"]
    summary = {
        "steps": steps, "wall_s": wall, "first_step_s": t_first, "step_ms": step_s * 1e3,
        f"{unit}_per_s": per_step / step_s, "peak_mem_gib": peak_gib,
        "first_loss": losses[0], "last_loss": losses[-1],
        "input_wait_seconds": prog.get("input_wait_seconds"),
        "input_starved_steps": prog.get("input_starved_steps"),
        "launches_per_step": {k: v / steps for k, v in launches.items() if v},
    }
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses not finite: {losses}")
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, f["sites"] * steps)}
    if launches != want:
        raise AssertionError(f"{name}: flash launches {launches}, want {want}")
    return summary, launches


def _t5_generate(torch, fa, t5):
    """``t5.greedy_generate`` at T5-base width (bf16, flash): 8 sources of
    512 tokens, 64 generated; the encoder pass launches the masked flash
    forward once a layer and nothing else does. Encoder ms, per-token ms
    and the device-idle share of a token, as the generate phase measures
    them; a sampled stream repeats under its key."""
    import numpy as np

    g = T5_GENERATE
    cfg = t5.base_config(attention_impl="flash")
    model = t5.make_task(cfg, seq_len=g["src"], batch_size=g["batch"],
                         attn_fn=fa.flash_attention).init(torch.Generator().manual_seed(0))
    model = model.to(DEVICE).eval()
    rng = np.random.default_rng(g["seed"])
    src = torch.from_numpy(rng.integers(2, cfg.vocab_size, (g["batch"], g["src"]))).to(DEVICE)
    n = g["gen"]
    t5.greedy_generate(cfg, model, src, n)  # warm-up
    fa.reset_launches()
    tokens = t5.greedy_generate(cfg, model, src, n)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    want = {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd_wgmma": cfg.num_layers}
    if launches != want:
        raise AssertionError(f"t5 generate launches {launches}, want {want}")
    tok = tokens.cpu().numpy()
    if tok.shape != (g["batch"], n) or not ((0 <= tok) & (tok < cfg.vocab_size)).all():
        raise AssertionError(f"t5 greedy tokens malformed: {tok.shape}")
    with torch.no_grad():
        _, enc_ms, enc_dev = _timed(torch, lambda: model.encode(src), profiled=True)
    _, gen_ms, gen_dev = _timed(torch, lambda: t5.greedy_generate(cfg, model, src, n),
                                profiled=True)
    samp = dict(rng=g["key"], temperature=0.8, top_k=50, top_p=0.95)
    s1 = t5.generate(cfg, model, src, n, **samp)
    if not torch.equal(s1, t5.generate(cfg, model, src, n, **samp)):
        raise AssertionError("t5: the same key gave another sampled stream")
    tok_ms = (gen_ms - enc_ms) / n
    tok_dev = (gen_dev[0] - enc_dev[0]) / n
    summary = {"batch": g["batch"], "src": g["src"], "gen": n, "encoder_ms": enc_ms,
               "encoder_device_ms": enc_dev[0], "generate_ms": gen_ms,
               "generate_device_ms": gen_dev[0], "generate_activities": gen_dev[1],
               "token_ms": tok_ms, "token_device_ms": tok_dev,
               "token_idle_share": 1.0 - tok_dev / tok_ms,
               "tokens_per_s": g["batch"] * n / (gen_ms * 1e-3),
               "flash_fwd_launches": launches["flash_fwd_wgmma"]}
    del model
    torch.cuda.empty_cache()
    return summary, launches


def phase_families(torch, fa):
    """BERT-base MLM, ViT-B/16 and T5-base at their published widths on
    the card (docstring phase 12). Returns the launches of the paths it
    drives: the three ``train`` runs and T5's greedy generate."""
    from tfk8s_tpu_torch.models import bert, t5, vit

    modules = {"bert": bert, "vit": vit, "t5": t5}
    total = dict.fromkeys(fa.KERNELS, 0)
    for name, module in modules.items():
        summary, launches = _family_train(torch, fa, name, module)
        for k, v in launches.items():
            total[k] += v
        e = FAMILIES[name]["env"]
        batch = int(e["TFK8S_BATCH_SIZE"])
        summary["staged"] = _staged_step(
            torch, _family_task(name, module, module.base_config(),
                                batch, attn_fn=fa.flash_attention),
            FAMILY_CHECK["staged_steps"])
        unit, per_step = FAMILIES[name]["per_step"]
        summary["staged"][f"staged_{unit}_per_s"] = \
            per_step / (summary["staged"]["staged_step_ms"] * 1e-3)
        log(f"families {name} train: {json.dumps(summary)}")
        log(f"families {name} flash vs plain: "
            f"{json.dumps(_family_check(torch, fa, name, module))}")
        log(f"families {name} f32 small, card vs cpu: "
            f"{json.dumps(_family_f32(torch, fa, name, module))}")
    summary, launches = _t5_generate(torch, fa, t5)
    for k, v in launches.items():
        total[k] += v
    log(f"families t5 generate: {json.dumps(summary)}")
    # the flash kernels at each family's training call, against their plain
    # versions and SDPA (a boolean attn_mask where masked), device times
    for i, (case_name, b, length, lengths) in enumerate(FAMILY_KERNEL_CASES):
        log(f"case {case_name}:")
        check_case(fa, Case(case_name, b, length, length, 12, 64, torch.bfloat16,
                            lengths=lengths, seed=31 + i), iters=10, profile=True)
        torch.cuda.empty_cache()
    return total


# phase parallel: the sequence and expert axes at full width
PARALLEL_ENV = {
    "TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8", "TFK8S_ATTENTION_IMPL": "flash",
    "TFK8S_NUM_EXPERTS": "8", "TFK8S_TRAIN_STEPS": "10", "TFK8S_LOG_EVERY": "1",
    "TFK8S_LEARNING_RATE": "3e-4", "TFK8S_SEED": "0",
}
# the gangs, each through its family's train(env): BERT-base at seq 512 on
# {"sequence": 2} (Ulysses over the flash kernels, and ring), GPT-2-small at
# seq 1024 through ring and with the planted ring fault, GPT-2-small + 8
# experts on {"expert": 2}; the first of gang_steps steps against one process
PARALLEL = dict(bert_seq=512, bert_batch=8, gpt_seq=1024, gpt_batch=8, seed=41,
                staged_steps=3, gang_steps=2, timeout_s=600)
# base-width bounds, gang (or remat) against one process: loss atol, and
# every gradient's relative L2 distance (FAMILY_GRAD_REL_L2)
PARALLEL_LOSS_ATOL = 2e-2
# the dispatch and combine products as the reference formulates them, for
# GPT-2-small + 8 experts at batch 8, seq 1024, top-1 (6 MoE layers, 160
# slots an expert): 2 * g * s * e * c * m float32 FLOPs a product. The
# reckoning counts three products a product with the backward; the step
# needs five a layer (the dispatch's 0/1 route takes no gradient)
MOE_PRODUCT_FLOP = 2 * 8 * 1024 * 8 * 160 * 768
MOE_DISPATCH_TFLOP = 6 * 5 * MOE_PRODUCT_FLOP / 1e12
MOE_RECKONED_TFLOP = 6 * 2 * 3 * MOE_PRODUCT_FLOP / 1e12

GLOO_PROBE = r"""
import json, os, sys
import torch
import torch.distributed as dist

rank, n = int(os.environ["RANK"]), 2
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=n)
x = torch.arange(8, dtype=torch.float32) + 100 * rank


def run(t):
    kind = os.environ["KIND"]
    if kind == "all_reduce":
        t = t.clone()
        dist.all_reduce(t)
        return t
    if kind == "all_gather":
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        return torch.cat(parts)
    if kind == "all_to_all":
        ins = [c.contiguous() for c in t.chunk(n)]
        outs = [torch.empty_like(c) for c in ins]
        dist.all_to_all(outs, ins)
        return torch.cat(outs)
    out = torch.empty_like(t)  # send/recv
    ops = [dist.P2POp(dist.isend, t, 1 - rank), dist.P2POp(dist.irecv, out, 1 - rank)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


try:
    got = run(x.cuda()).cpu()
    result = "ok" if torch.equal(got, run(x)) else "wrong"
except Exception as e:  # noqa: BLE001 - the refusal is the finding
    result = "error: " + str(e).splitlines()[0][:160]
print("PROBE " + json.dumps(result), flush=True)
"""
GLOO_KINDS = ("all_reduce", "all_gather", "all_to_all", "send/recv")


def _gloo_probe():
    """Which collectives a gloo group takes CUDA tensors for: each kind in
    a fresh pair of processes on the card (gloo may abort a process on a
    CUDA tensor), all pairs at once, the card result held to the host's.
    ``parallel/collectives.py`` stages through host memory the kinds that
    are not "ok" here. -> {kind: "ok" | "wrong" | "error: ..." | "aborted
    (exit n)" | "hung"}."""
    import socket

    pairs = {}
    for kind in GLOO_KINDS:
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        pairs[kind] = [subprocess.Popen(
            [sys.executable, "-c", GLOO_PROBE], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True,
            env=dict(os.environ, RANK=str(r), KIND=kind, INIT=f"tcp://127.0.0.1:{port}"))
            for r in range(2)]
    out = {}
    for kind, procs in pairs.items():
        try:
            text = procs[0].communicate(timeout=120)[0]
            procs[1].communicate(timeout=30)
            lines = [ln for ln in text.splitlines() if ln.startswith("PROBE ")]
            out[kind] = json.loads(lines[0][6:]) if procs[0].returncode == 0 and lines \
                else f"aborted (exit {procs[0].returncode})"
        except subprocess.TimeoutExpired:
            out[kind] = "hung"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


# the one-card gloo gangs (phases 11, 13-15, 17, 18) and the one-process
# runs each is held to train GANG_LAYERS layers of every transformer family:
# the published widths, head counts, sequence lengths and batches, the
# depth cut (a gang's step is mostly its gradients' trips through gloo and
# the host, which scale with the parameters). The entry-point env carries
# it as GANG_LAYERS; the nccl phase's gangs keep the full depth
GANG_LAYERS = 2
TRANSFORMER_FAMILIES = ("gpt", "bert", "t5", "vit")


@contextlib.contextmanager
def gang_depth(layers):
    """Inside this block every transformer family's presets (base and
    tiny) build ``layers`` layers unless the caller names a depth (None:
    the presets as they are)."""
    import functools
    import importlib

    if layers is None:
        yield
        return
    saved = []
    for family in TRANSFORMER_FAMILIES:
        module = importlib.import_module(f"tfk8s_tpu_torch.models.{family}")
        for attr in ("base_config", "tiny_config"):
            preset = getattr(module, attr)
            saved.append((module, attr, preset))
            setattr(module, attr, functools.partial(preset, num_layers=int(layers)))
    try:
        yield
    finally:
        for module, attr, preset in saved:
            setattr(module, attr, preset)


def family_layers(module, env):
    """The layers ``module``'s preset builds under ``env`` (its
    ``TFK8S_MODEL_PRESET`` and ``GANG_LAYERS``)."""
    with gang_depth(env.get("GANG_LAYERS")):
        tiny = env.get("TFK8S_MODEL_PRESET") == "tiny"
        return (module.tiny_config if tiny else module.base_config)().num_layers


# one-process references by (family, env): a phase whose gang is held to
# the same run as an earlier phase's takes that run's result
_ONE_PROCESS = {}


def one_process(torch, fa, module, env):
    """:func:`entry_steps` of ``module.train(env)``, run once per (family,
    env) in this process: ``(losses, grads, step_ms, launches, fresh)``,
    ``fresh`` False where an earlier phase ran it (its launches are that
    run's and count there)."""
    key = (module.__name__, json.dumps(env, sort_keys=True))
    fresh = key not in _ONE_PROCESS
    if fresh:
        torch.cuda.empty_cache()
        _ONE_PROCESS[key] = entry_steps(torch, fa, module, env)
        torch.cuda.empty_cache()
    return (*_ONE_PROCESS[key], fresh)


def entry_steps(torch, fa, module, env, grads_of=None):
    """``<family>:train(env)`` as a user calls it (at ``env``'s
    GANG_LAYERS depth, :func:`gang_depth`), watched from an
    optimizer step pre-hook: the first step's whole update gradient (on
    the host, in the optimizer's parameter order, after the entry point's
    reductions; ``grads_of()`` gives it where the rank holds shards), the
    ms from the first update to the second (one step: the next batch,
    forward, backward, reductions, norm), the logged losses and the flash
    launches of the run (counts zeroed just before it)."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    seen = []

    def hook(opt, args, kwargs):
        grads = None
        if not seen and grads_of is not None:
            grads = grads_of()
        elif not seen:
            grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
                     for g in opt.param_groups for p in g["params"]]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seen.append((time.perf_counter(), grads))

    handle = register_optimizer_step_pre_hook(hook)
    fa.reset_launches()
    try:
        with gang_depth(env.get("GANG_LAYERS")):
            history = module.train(env)
    finally:
        handle.remove()
    launches = dict(fa.LAUNCHES)
    step_ms = (seen[1][0] - seen[0][0]) * 1e3 if len(seen) > 1 else None
    return [h["loss"] for h in history], seen[0][1], step_ms, launches


PAR_WORKER = r"""
import importlib, json, os, sys, time
T0 = time.perf_counter()
sys.path.insert(0, os.environ["CHIP_SMOKE_ROOT"])
import torch

from chip_smoke import entry_steps, moe_block_out, planted
from tfk8s_tpu_torch.ops import flash_attention as fa
from tfk8s_tpu_torch.ops import group_norm as gn
from tfk8s_tpu_torch.parallel import collectives
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.launcher import ProcessContext, initialize_distributed

base = dict(os.environ)
# the gang's backend: gloo lets ranks share one card (the entry point
# would pick NCCL on a card); each run's entry point joins this group
ctx = ProcessContext.from_env(base)
initialize_distributed(ctx, base, backend=base["GANG_BACKEND"])
# the head count of every flash forward this rank runs
heads, flash_fwd = set(), fa.flash_fwd
fa.flash_fwd = lambda q, *a, **kw: heads.add(q.shape[2]) or flash_fwd(q, *a, **kw)
# each run's layout and model: where the rank holds shards (fsdp, expert,
# tensor), its first update's whole gradient is gathered over the mesh
held, init_state = [], ttrain.Trainer.init_state


def holding(self):
    state = init_state(self)
    held.append((self.parallel, state.model))
    return state


def grads_of():
    parallel, model = held[-1]
    return [g.float().cpu() for g in parallel.whole_grads(model).values()]


ttrain.Trainer.init_state = holding
# a batch of runs a line on stdin, until it closes
for batch in map(json.loads, sys.stdin):
    for run in batch:
        t_run = time.perf_counter()
        env = dict(base, **run["env"])
        heads.clear()
        held.clear()
        collectives.HOST_STAGED.clear()
        gn.reset_launches()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        module = importlib.import_module("tfk8s_tpu_torch.models." + env["FAMILY"])
        whole = bool(env.get("WHOLE_GRADS"))
        with planted(torch, env.get("FAULT")):
            losses, grads, step_ms, launches = entry_steps(torch, fa, module, env,
                                                           grads_of if whole else None)
            # the MoE block over this rank's mesh on a fixed input; every rank
            # holds the whole output
            block = moe_block_out(torch, held[-1][0].layout, env) if env.get("MOE_BLOCK") else None
        # whole gradients are the same on every rank: the first one's is kept
        keep = not whole or ctx.process_id == 0
        torch.save(grads if keep else None, "%s-%d.pt" % (run["out"], ctx.process_id))
        if block is not None and ctx.process_id == 0:
            torch.save(block, run["out"] + "-moe.pt")
        print("RANK " + json.dumps({
            "name": run["name"], "rank": ctx.process_id, "losses": losses, "step_ms": step_ms,
            "launches": launches, "gn_launches": dict(gn.LAUNCHES), "heads": sorted(heads),
            "host_staged": sorted(collectives.HOST_STAGED),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_available()
            else None, "started_s": t_run - T0, "run_s": time.perf_counter() - t_run}), flush=True)
        del grads, block
        held.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print("BATCH_DONE", flush=True)
"""


@contextlib.contextmanager
def planted(torch, fault):
    """The planted fault ``fault`` (None: none) for one gang run, undone
    after it: ``ring_offset``, the ring's causal mask without the blocks'
    global offset; ``row_unsummed``, every row split's output left as this
    rank's part; ``record_shifted``, the last stage records microbatch
    t - s - 1 for t - s; ``expert_wo_unsummed``, each expert's ``wo`` block
    left unsummed over tensor; ``ulysses_heads_reversed``, Ulysses'
    exchange back puts the sequence ranks' head blocks in reverse order;
    ``sequence_counted``, the pipelined family's every sequence rank taking
    the whole sequence's loss as a replica of its batch block (its masked
    mean over the batch axes alone), so the reduction's sum over the
    sequence group counts the gradient once a rank."""
    if fault is None:
        yield
        return
    from tfk8s_tpu_torch.models import pipelined
    from tfk8s_tpu_torch.parallel import (collectives, moe, pipeline, ring_attention,
                                          tensor_parallel, ulysses)

    exchange = ulysses.all_to_all

    def reversed_back(x, split_dim, concat_dim, group):
        out = exchange(x, split_dim, concat_dim, group)
        if concat_dim != 2:
            return out
        return torch.cat(out.chunk(collectives.group_size(group), dim=2)[::-1], dim=2)

    owner, attr, fn = {
        "ring_offset": (ring_attention, "_q_pos", lambda q, k, ring, me: (
            torch.arange(q.shape[1], device=q.device) + ring * (k.shape[1] - q.shape[1]))),
        "row_unsummed": (tensor_parallel, "sum_over", lambda x, group: x),
        "record_shifted": (pipeline._Schedule, "_record",
                           lambda self, outputs, mu, y: outputs.__setitem__(mu - 1, y)),
        "expert_wo_unsummed": (moe, "sum_blocks", lambda part, tp, bias=None: part),
        "ulysses_heads_reversed": (ulysses, "all_to_all", reversed_back),
        "sequence_counted": (pipelined, "sequence_share",
                             lambda mesh: (mesh.group("data", "fsdp"), 0, 1)),
    }[fault]
    saved = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


class GangPool:
    """``n`` PAR_WORKER processes joined on a free port over ``backend``
    (gloo ranks share the one card; NCCL ranks take a card each). A batch
    of runs is one line on every process's stdin, answered by a RANK line a
    run and a BATCH_DONE line from each process; the processes end when
    their stdin closes. A gang kept for several batches pays its processes'
    start-up and first-run costs once. A process that exits before, or a
    batch past PARALLEL["timeout_s"], kills the processes and fails the
    batch."""

    def __init__(self, n, backend):
        import queue
        import socket
        import threading

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        root = os.path.dirname(os.path.abspath(__file__))
        self.n, self.backend, self.procs, self.queues = n, backend, [], []
        for rank in range(n):
            penv = dict(os.environ, CHIP_SMOKE_ROOT=root, TFK8S_DISTRIBUTED="1",
                        TFK8S_NUM_PROCESSES=str(n), TFK8S_PROCESS_ID=str(rank),
                        TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", GANG_BACKEND=backend)
            if DEVICE == "cpu":
                penv["TFK8S_DEVICE"] = "cpu"
            p = subprocess.Popen([sys.executable, "-c", PAR_WORKER], env=penv, cwd=root,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            q = queue.Queue()

            def drain(p=p, q=q):
                for line in p.stdout:
                    q.put(line)
                q.put(None)

            threading.Thread(target=drain, daemon=True).start()
            self.procs.append(p)
            self.queues.append(q)

    def batch(self, runs):
        """The processes' output of the batch ``runs`` (its JSON line), a
        text a process."""
        import queue

        for p in self.procs:
            p.stdin.write(runs + "\n")
            p.stdin.flush()
        deadline = time.perf_counter() + PARALLEL["timeout_s"]
        texts = []
        for rank, q in enumerate(self.queues):
            lines = []
            while True:
                try:
                    line = q.get(timeout=max(deadline - time.perf_counter(), 0.1))
                except queue.Empty:
                    self.close()
                    raise AssertionError(f"gang of {self.n} ran past "
                                         f"{PARALLEL['timeout_s']} s")
                if line is None:
                    self.close()
                    raise AssertionError(f"gang rank {rank} exited "
                                         f"{self.procs[rank].wait()}:\n"
                                         f"{''.join(lines)[-3000:]}")
                if line.startswith("BATCH_DONE"):
                    break
                lines.append(line)
            texts.append("".join(lines))
        return texts

    def close(self):
        """End the processes: on the end of their stdin, or by force."""
        for p in self.procs:
            if not p.stdin.closed:
                p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# the gloo gangs kept across phases, by their size
_GANGS = {}


def close_gangs():
    while _GANGS:
        _GANGS.popitem()[1].close()


def _run_par_gangs(n_procs, runs, backend="gloo"):
    """``n_procs`` PAR_WORKER processes (:class:`GangPool`: over gloo the
    gang of that size kept across phases, over NCCL a launch of its own)
    drive the ``runs`` in order, each ``{"name", "env", "out", "want"}``
    (and ``whole``, ``assemble``): an entry point's env over the process's
    own (its ``FAMILY``, ``TFK8S_MESH``, ``FAULT`` ...). Returns ``{name:
    (records, grads)}``: the run's RANK records in rank order, and the
    whole gradient of its first step put together from the ranks' files: a
    parameter shaped unlike ``want``'s (an expert shard, a tensor block) is
    the blocks of the ranks ``whole`` (default: every rank) concatenated in
    rank order along the dimension they split; ``assemble(parts)`` puts
    together ranks holding different parameters (pipeline stages); with
    ``WHOLE_GRADS`` only rank 0's file holds the gathered gradient."""
    import torch

    label = ", ".join(r["name"] for r in runs)
    spec = json.dumps([{k: r[k] for k in ("name", "env", "out")} for r in runs])
    t0 = time.perf_counter()
    if backend == "gloo":
        gang = _GANGS.get(n_procs) or _GANGS.setdefault(n_procs, GangPool(n_procs, backend))
    else:
        gang = GangPool(n_procs, backend)
    try:
        outs = gang.batch(spec)
        if backend != "gloo":
            gang.close()
            if any(p.returncode for p in gang.procs):
                raise AssertionError(f"exit codes {[p.returncode for p in gang.procs]}")
    except Exception as e:  # noqa: BLE001 — the gang is ended, the batch fails
        gang.close()
        _GANGS.pop(n_procs, None)
        raise AssertionError(f"{label}: {e}") from None
    records = {r["name"]: [] for r in runs}
    for rank, text in enumerate(outs):
        lines = [json.loads(ln[5:]) for ln in text.splitlines() if ln.startswith("RANK ")]
        if len(lines) != len(runs):
            raise AssertionError(f"{label}: rank {rank} printed {len(lines)} results:\n"
                                 f"{text[-3000:]}")
        for rec in lines:
            records[rec["name"]].append(rec)
    # where a batch's time goes: the processes' age at its first run (their
    # start-up, for a new gang), each run's slowest rank, then the
    # gradients' assembly here
    first = records[runs[0]["name"]]
    timing = {"processes_s": time.perf_counter() - t0,
              "started_s": max(r["started_s"] for r in first),
              "runs_s": {name: max(r["run_s"] for r in recs) for name, recs in records.items()}}
    t0 = time.perf_counter()
    result = {}
    for run in runs:
        name, out, want = run["name"], run["out"], run["want"]
        parts = [torch.load(f"{out}-{r}.pt") for r in range(n_procs)]
        parts = [p for p in parts if p is not None]  # whole gradients: rank 0's only
        for r in range(n_procs):
            os.remove(f"{out}-{r}.pt")
        if run.get("assemble") is not None:
            parts = [run["assemble"](parts)]
        if any(len(p) != len(want) for p in parts):
            raise AssertionError(f"{name}: {[len(p) for p in parts]} parameters, "
                                 f"want {len(want)}")
        whole = range(len(parts)) if run.get("whole") is None else run["whole"]
        grads = []
        for w, ps in zip(want, zip(*parts)):
            if ps[0].shape == w.shape:
                grads.append(ps[0])
                continue
            dim = next(d for d in range(w.dim()) if ps[0].shape[d] != w.shape[d])
            grads.append(torch.cat([ps[r] for r in whole], dim=dim))
        result[name] = (sorted(records[name], key=lambda r: r["rank"]), grads)
    timing["assembly_s"] = time.perf_counter() - t0
    log(f"gang of {n_procs} ({backend}): {json.dumps(timing)}")
    return result


def _gang_check(name, records, grads, loss, want, launches, fault=False, heads=None,
                block_rel_l2=None):
    """The gang's first-step loss and gradient against one process's (and
    ``block_rel_l2``, an MoE block's output's relative L2 distance from one
    process's on the same input): within the base-width bounds, or (a
    planted fault) beyond one of them; every rank's flash launches exactly
    ``launches``, and (``heads``) every flash forward at that many heads."""
    errs = {"loss_err": max(abs(r["losses"][0] - loss) for r in records),
            "grad_rel_l2": _grads_rel_l2(dict(enumerate(grads)), dict(enumerate(want))),
            "finite": all(math.isfinite(x) for r in records for x in r["losses"])}
    if block_rel_l2 is not None:
        errs["moe_block_rel_l2"] = block_rel_l2
    within = errs["finite"] and errs["loss_err"] <= PARALLEL_LOSS_ATOL and all(
        errs[k] <= FAMILY_GRAD_REL_L2 for k in ("grad_rel_l2", "moe_block_rel_l2") if k in errs)
    if within == fault:
        raise AssertionError(f"{name}: {errs} {'passes as a planted fault' if fault else ''}"
                             f" (bounds: loss {PARALLEL_LOSS_ATOL}, relative L2 "
                             f"{FAMILY_GRAD_REL_L2})")
    for r in records:
        if r["launches"] != launches:
            raise AssertionError(f"{name}: rank {r['rank']} flash launches {r['launches']}, "
                                 f"want {launches}")
        if heads is not None and r["heads"] != heads:
            raise AssertionError(f"{name}: rank {r['rank']} flash heads {r['heads']}, "
                                 f"want {heads}")
    return errs


def _moe_split(torch, task, seq):
    """One profiler trace of the MoE GPT's staged step, its device time
    split by what ran it: the float32 dispatch and combine products
    (batched products over the ``e * c`` slots), the expert FFN (batched
    products over ``mlp_dim``), the float32 tied head (products over the
    vocabulary), the flash kernels, AdamW (``Optimizer.step``), the other
    products, and the rest."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tfk8s_tpu_torch.runtime.train import TrainConfig, Trainer

    trainer = Trainer(task, TrainConfig(steps=10 ** 6, learning_rate=1e-4), DEVICE)
    state = trainer.init_state()
    staged = trainer.to_device(task.make_batch(np.random.default_rng(0), task.batch_size))
    trainer.train_step(state, staged)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        trainer.train_step(state, staged)
        torch.cuda.synchronize()
    busy, _ = _device_busy_ms(torch, prof)
    model = state.model
    moe = next(m for m in model.modules() if type(m).__name__ == "SwitchMoeBlock")
    ec = moe.wi.shape[0] * max(int(moe.capacity_factor * moe.top_k * seq / moe.num_experts), 1)
    vocab, mlp = model.cfg.vocab_size, model.cfg.mlp_dim
    split = dict.fromkeys(("dispatch_combine", "expert_ffn", "head", "flash", "adamw",
                           "other_products", "rest"), 0.0)
    gemms = ("aten::bmm", "aten::mm", "aten::addmm", "aten::baddbmm")
    for row in prof.key_averages(group_by_input_shape=True):
        dev_ms = (getattr(row, "device_time_total", None)
                  or getattr(row, "cuda_time_total", 0.0)) * 1e-3
        if row.key.startswith("Optimizer.step"):
            split["adamw"] += dev_ms
            continue
        if row.key not in gemms:
            continue
        dims = {d for shape in (row.input_shapes or []) for d in shape}
        if vocab in dims:
            split["head"] += dev_ms
        elif row.key == "aten::bmm" and mlp in dims:
            split["expert_ffn"] += dev_ms
        elif row.key == "aten::bmm" and ec in dims:
            split["dispatch_combine"] += dev_ms
        else:
            split["other_products"] += dev_ms
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "tfk8s_" in e.name:
            split["flash"] += e.time_range.elapsed_us() * 1e-3
    split["rest"] = busy - sum(v for k, v in split.items() if k != "rest")
    split["busy"] = busy
    split["dispatch_combine_tflop_per_s"] = MOE_DISPATCH_TFLOP / max(
        split["dispatch_combine"] * 1e-3, 1e-9)
    del state, trainer, staged
    torch.cuda.empty_cache()
    return split


def _moe_train(torch, fa, gpt, env, label):
    """``gpt:train(env)`` with MoE: losses and ``moe_aux`` finite, each
    tensor-core flash kernel launched 12 times a step; per log step its
    ms, tokens/s and ``moe_aux``. Returns (summary, launches)."""
    from tfk8s_tpu_torch.runtime import progress

    steps = int(env["TFK8S_TRAIN_STEPS"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    progress.clear()
    fa.reset_launches()
    history = gpt.train(env)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    tokens = int(env["TFK8S_BATCH_SIZE"]) * int(env["TFK8S_SEQ_LEN"])
    prev = 0.0
    for h in history:
        t = h["step"] / h["steps_per_s"]
        log(f"  {label} step {h['step']}: {json.dumps({'step_ms': (t - prev) * 1e3, 'tokens_per_s': tokens / max(t - prev, 1e-9), 'loss': h['loss'], 'moe_aux': h['moe_aux'], 'peak_gib': torch.cuda.max_memory_allocated() / 2**30})}")
        prev = t
    losses = [h["loss"] for h in history] + [h["moe_aux"] for h in history]
    if len(history) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses or moe_aux not finite: {losses}")
    layers = gpt.base_config().num_layers if env.get("TFK8S_MODEL_PRESET") != "tiny" \
        else gpt.tiny_config().num_layers
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * steps)}
    if launches != want:
        raise AssertionError(f"{label}: flash launches {launches}, want {want}")
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    # one step: its time, the first step's (with the start-up it pays)
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"]) \
        if len(history) > 1 else t_first
    return {"steps": steps, "first_step_s": t_first, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "peak_mem_gib":
            torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": {k: v / steps for k, v in launches.items() if v}}, launches


def _moe_f32_run(torch, gpt, env):
    """(a)'s ten steps again with float32 activations (TF32 off) and plain
    attention, through the same Trainer, initial parameters and batch
    stream: each step's loss and ``moe_aux``, to tell a bfloat16 effect in
    the router's balance from the formulation's own."""
    from tfk8s_tpu_torch.runtime.train import TrainConfig, Trainer

    tiny = env.get("TFK8S_MODEL_PRESET") == "tiny"
    cfg = (gpt.tiny_config if tiny else gpt.base_config)(
        num_experts=int(env["TFK8S_NUM_EXPERTS"]), dtype=torch.float32)
    task = gpt.make_task(cfg, seq_len=int(env["TFK8S_SEQ_LEN"]),
                         batch_size=int(env["TFK8S_BATCH_SIZE"]))
    config = TrainConfig(steps=int(env["TFK8S_TRAIN_STEPS"]), log_every=1,
                         learning_rate=float(env["TFK8S_LEARNING_RATE"]),
                         seed=int(env["TFK8S_SEED"]))
    torch.cuda.empty_cache()
    _, history = Trainer(task, config, DEVICE).fit()
    torch.cuda.empty_cache()
    out = [{"loss": h["loss"], "moe_aux": h["moe_aux"]} for h in history]
    if not all(math.isfinite(v) for r in out for v in r.values()):
        raise AssertionError(f"moe float32: not finite: {out}")
    return out


def _moe_checks(torch, fa, gpt):
    """(b): identical experts = the dense MLP at base width; a small f32
    MoE GPT through the kernels on the card against the CPU plain path;
    remat against no remat at the trained configuration (peak memory of
    each)."""
    import copy
    import dataclasses

    import numpy as np

    from tfk8s_tpu_torch.models.transformer import MlpBlock
    from tfk8s_tpu_torch.parallel.moe import SwitchMoeBlock

    out = {}
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    base = (gpt.tiny_config if tiny else gpt.base_config)(num_experts=8)
    gen = torch.Generator().manual_seed(2)
    dense, block = MlpBlock(base), SwitchMoeBlock(base, 8, capacity_factor=8.0)
    with torch.no_grad():
        for lin in (dense.wi, dense.wo):
            torch.nn.init.xavier_uniform_(lin.weight, generator=gen)
            lin.bias.zero_()
        block.init_weights(gen)
        block.wi.copy_(dense.wi.weight.t().expand_as(block.wi))
        block.wo.copy_(dense.wo.weight.t().expand_as(block.wo))
        dense, block = dense.to(DEVICE), block.to(DEVICE)
        x = torch.randn(4, 256, base.embed_dim, generator=gen).to(DEVICE, base.dtype)
        y, _ = block(x)
        gate = torch.softmax(x.float() @ block.router, dim=-1).max(dim=-1).values
        want = dense(x).float() * gate[..., None]
    err, ok = _err([(y, want)], BF16_ATOL, BF16_RTOL)
    out["identical_experts_max_abs_err"] = err
    if not ok:
        raise AssertionError(f"identical experts vs dense MLP: {err} beyond bf16 bounds")

    small = gpt.tiny_config(dtype=torch.float32, embed_dim=64, num_heads=2, head_dim=32,
                            mlp_dim=128, num_layers=2, vocab_size=256, max_len=128,
                            num_experts=4)
    task = gpt.make_task(small, seq_len=96, batch_size=2, attn_fn=fa.flash_attention)
    host = task.make_batch(np.random.default_rng(6), 2)
    cpu = task.init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(DEVICE)
    res = []
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        loss, grads = _loss_and_grads(torch, task.loss_fn, model, batch)
        res.append((loss, {n: g.cpu() for n, g in grads.items()}))
    l_err = abs(res[0][0] - res[1][0])
    g_err = max(float((res[0][1][n] - res[1][1][n]).abs().max()) for n in res[0][1])
    out["f32_small_card_vs_cpu"] = {"loss_err": l_err, "max_grad_err": g_err}
    if not (l_err <= F32_GRAD_ATOL and g_err <= F32_GRAD_ATOL):
        raise AssertionError(f"f32 MoE GPT card vs CPU: {out['f32_small_card_vs_cpu']}")

    seq, batch = int(PARALLEL_ENV["TFK8S_SEQ_LEN"]), int(PARALLEL_ENV["TFK8S_BATCH_SIZE"])
    host = gpt.make_batch_fn(base.vocab_size, seq)(np.random.default_rng(7), batch)
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        task = gpt.make_task(cfg, seq_len=seq, batch_size=batch, attn_fn=fa.flash_attention)
        model = task.init(torch.Generator().manual_seed(0)).to(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = _loss_and_grads(torch, task.loss_fn, model, _device(torch, host))
        torch.cuda.synchronize()
        runs[remat] = (loss, {n: g.cpu() for n, g in grads.items()},
                       torch.cuda.max_memory_allocated() / 2**30)
        del model, grads
        torch.cuda.empty_cache()
    l_err = abs(runs[True][0] - runs[False][0])
    g_rel = _grads_rel_l2(runs[True][1], runs[False][1])
    out["remat"] = {"loss_err": l_err, "grad_rel_l2": g_rel,
                    "peak_gib_no_remat": runs[False][2], "peak_gib_remat": runs[True][2]}
    if not (l_err <= F32_GRAD_ATOL and g_rel <= F32_GRAD_ATOL):
        raise AssertionError(f"remat vs no remat: {out['remat']}")
    return out


def phase_parallel(torch, gpt, fa, root):
    """The sequence and expert axes (docstring phase 13, (a)-(d)). Returns
    the launches of the paths it drives in this process: the MoE
    ``gpt:train`` runs."""
    total = dict.fromkeys(fa.KERNELS, 0)
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    # (a) GPT-2-small + 8 experts through gpt:train, then one top-2 step
    summary, launches = _moe_train(torch, fa, gpt, dict(PARALLEL_ENV), "moe")
    for k, v in launches.items():
        total[k] += v
    log(f"parallel moe train: {json.dumps(summary)}")
    # two steps: the second is a steady one
    top2 = dict(PARALLEL_ENV, TFK8S_MOE_TOP_K="2", TFK8S_TRAIN_STEPS="2")
    summary2, launches = _moe_train(torch, fa, gpt, top2, "moe top-2")
    for k, v in launches.items():
        total[k] += v
    log(f"parallel moe top-2 step: {json.dumps(summary2)}")
    log(f"parallel moe float32 steps: {json.dumps(_moe_f32_run(torch, gpt, PARALLEL_ENV))}")
    seq, batch = int(PARALLEL_ENV["TFK8S_SEQ_LEN"]), int(PARALLEL_ENV["TFK8S_BATCH_SIZE"])
    moe_cfg = (gpt.tiny_config if tiny else gpt.base_config)(num_experts=8)
    task = gpt.make_task(moe_cfg, seq_len=seq, batch_size=batch, attn_fn=fa.flash_attention)
    split = _moe_split(torch, task, seq)
    split["reckoned_dispatch_combine_tflop"] = MOE_RECKONED_TFLOP
    split["needed_dispatch_combine_tflop"] = MOE_DISPATCH_TFLOP
    split["needed_dispatch_combine_min_ms_at_67_tflops"] = MOE_DISPATCH_TFLOP / 67 * 1e3
    log(f"parallel moe staged-step split (device ms): {json.dumps(split)}")
    staged = _staged_step(torch, task, PARALLEL["staged_steps"])
    log(f"parallel moe staged step: {json.dumps(staged)}")
    # (b) MoE correctness on the card
    log(f"parallel moe checks: {json.dumps(_moe_checks(torch, fa, gpt))}")
    # the flash kernels at Ulysses' local call: 12 heads over 2 ranks
    for i, causal in enumerate((False, True)):
        for dtype in (torch.bfloat16, torch.float32):
            name = f"ulysses_local{'_causal' if causal else ''}"
            log(f"case {name} {dtype}:")
            check_case(fa, Case(name, PARALLEL["bert_batch"], PARALLEL["bert_seq"],
                                PARALLEL["bert_seq"], 6, 64, dtype, causal=causal,
                                seed=51 + i), iters=10, profile=True)
            torch.cuda.empty_cache()
    # (c)-(d) the gangs over gloo, two ranks sharing the card
    log(f"parallel gloo probe (CUDA tensors): {json.dumps(_gloo_probe())}")
    for k, v in _parallel_gangs(torch, gpt, fa, root, "gloo").items():
        total[k] += v
    return total


# (name, reference, mesh, entry-point env, planted fault): Ulysses by the
# policy (auto; 12 heads divide by 2), ring pinned
PARALLEL_GANGS = [
    ("bert_sequence_ulysses", "bert", '{"sequence": 2}', {"TFK8S_ATTENTION_IMPL": "auto"},
     False),
    ("bert_sequence_ring", "bert", '{"sequence": 2}', {"TFK8S_ATTENTION_IMPL": "ring"}, False),
    ("gpt_sequence_ring", "gpt", '{"sequence": 2}', {"TFK8S_ATTENTION_IMPL": "ring"}, False),
    ("gpt_sequence_ring_fault", "gpt", '{"sequence": 2}',
     {"TFK8S_ATTENTION_IMPL": "ring", "FAULT": "ring_offset"}, True),
    ("gpt_moe_expert", "gpt_moe", '{"expert": 2}',
     {"TFK8S_ATTENTION_IMPL": "flash", "TFK8S_NUM_EXPERTS": "8"}, False),
]


def _parallel_gangs(torch, gpt, fa, root, backend):
    """Each gang of PARALLEL_GANGS (the planted fault under gloo only)
    through its family's ``train(env)``, PARALLEL["gang_steps"] steps (a
    planted fault's one), its first step against one process's run of the
    same entry point on the same global batch (per_host input, one shard)
    with flash attention; over gloo at GANG_LAYERS layers. Every rank must
    launch each tensor-core flash kernel layers x steps times where its
    attention is flash (inside Ulysses too) and never where it is the
    ring. Returns the launches of the one-process runs."""
    from tfk8s_tpu_torch.models import bert

    work = os.path.join(root, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    p, steps = PARALLEL, PARALLEL["gang_steps"]
    modules = {"bert": bert, "gpt": gpt}
    total = dict.fromkeys(fa.KERNELS, 0)

    def base_env(fam, steps):
        return dict({"TFK8S_MODEL_PRESET": "tiny"} if tiny else {},
                    **({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {}),
                    **({"GANG_LAYERS": str(GANG_LAYERS)} if backend == "gloo" else {}),
                    TFK8S_SEQ_LEN=str(p[f"{fam}_seq"]), TFK8S_BATCH_SIZE=str(p[f"{fam}_batch"]),
                    TFK8S_TRAIN_STEPS=str(steps), TFK8S_LOG_EVERY="1",
                    TFK8S_LEARNING_RATE="1e-4", TFK8S_SEED=str(p["seed"]),
                    TFK8S_INPUT_MODE="per_host")

    refs, runs = {}, []
    for name, ref, mesh, extra, fault in PARALLEL_GANGS:
        if fault and backend != "gloo":
            continue
        fam = "bert" if ref == "bert" else "gpt"
        module = modules[fam]
        layers = family_layers(module, base_env(fam, steps))
        if ref not in refs:
            env = dict(base_env(fam, steps), TFK8S_ATTENTION_IMPL="flash")
            if ref == "gpt_moe":
                env["TFK8S_NUM_EXPERTS"] = extra["TFK8S_NUM_EXPERTS"]
            losses, grads, one_ms, launches, fresh = one_process(torch, fa, module, env)
            flash = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
                     **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * steps)}
            if launches != flash:
                raise AssertionError(f"{ref} one process: flash launches {launches}, "
                                     f"want {flash}")
            for k, v in launches.items():
                total[k] += v if fresh else 0
            refs[ref] = (losses[0], grads, one_ms)
        ring = extra["TFK8S_ATTENTION_IMPL"] == "ring"
        run_steps = 1 if fault else steps
        want_launches = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
                         **dict.fromkeys(fa.TENSOR_CORE_KERNELS,
                                         0 if ring else layers * run_steps)}
        env = dict(base_env(fam, run_steps), TFK8S_MESH=mesh, FAMILY=fam, **extra)
        runs.append(dict(name=name, env=env, out=os.path.join(work, name), want=refs[ref][1],
                         ref=ref, launches=want_launches, fault=fault))
    # the gangs run in one launch of two ranks, in turn
    t0 = time.perf_counter()
    results = _run_par_gangs(2, runs, backend)
    log(f"parallel: {len(runs)} gangs of 2 ranks in one launch ({backend}), "
        f"{time.perf_counter() - t0:.1f} s")
    for run in runs:
        name = run["name"]
        records, grads = results.pop(name)
        loss, want, one_ms = refs[run["ref"]]
        errs = _gang_check(f"{name} ({backend})", records, grads, loss, want, run["launches"],
                           run["fault"])
        del grads
        log(f"parallel gang {name} ({backend}): {json.dumps({**errs, 'one_process_loss': loss, 'one_process_step_ms': one_ms, 'ranks': records})}")
    shutil.rmtree(work, ignore_errors=True)
    del refs
    torch.cuda.empty_cache()
    return total


# phase tensor: the tensor axis at full width. Each family's gang runs its
# train(env) on TENSOR_MESH for gang_steps steps, its first update against
# one process's run of the same entry point (flash, per_host input of two
# shards in both, so a data axis sees the same global batch):
# (name, family, entry-point env, flash call sites a layer, planted fault)
TENSOR = dict(seed=61, gang_steps=2, dlrm_steps=20)
# (BERT's and ViT's batches are a quarter of the families phase's, T5's a
# half, to make room for the axes phase: a gang's step is gloo's host round
# trips, and the kernels at those families' calls are held apart below)
TENSOR_GANGS = [
    ("gpt_tensor", "gpt", {"TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8"}, 1, None),
    ("bert_tensor", "bert", {"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "8"}, 1, None),
    ("t5_tensor", "t5", {"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "8"}, 3, None),
    ("vit_tensor", "vit", {"TFK8S_IMAGE_SIZE": "224", "TFK8S_PATCH_SIZE": "16",
                           "TFK8S_NUM_CLASSES": "1000", "TFK8S_BATCH_SIZE": "16"}, 1, None),
    ("gpt_tensor_row_unsummed", "gpt", {"TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8"}, 1,
     "row_unsummed"),
]
TENSOR_MESH = {"tensor": 2}
# over NCCL on four cards: BASELINE.json configs[3]'s T5 layout, and GPT-2-small
# at three heads a rank: (name, family, mesh, entry-point env, sites a layer)
TENSOR_NCCL_GANGS = [
    ("t5_data_tensor", "t5", {"data": 2, "tensor": 2},
     {"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "16"}, 3),
    ("gpt_tensor4", "gpt", {"tensor": 4}, {"TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8"}, 1),
]
# the flash kernels at each family's call on a tensor rank, 6 of 12 heads,
# bf16: (name, batch, length, causal, key lengths); T5's keys as its
# FAMILY_KERNEL_CASES row pads them, ViT's 196 tokens ragged
TENSOR_KERNEL_CASES = [
    ("gpt_tensor_rank_causal", 8, 1024, True, None),
    ("bert_tensor_rank", 32, 512, False, None),
    ("t5_tensor_rank_key_mask", 16, 512, False, FAMILY_KERNEL_CASES[2][3]),
    ("vit_tensor_rank_ragged_196", 64, 196, False, None),
]


def _tensor_env(extra, backend="gloo", steps=None):
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    return dict({"TFK8S_MODEL_PRESET": "tiny"} if tiny else {},
                **({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {}),
                **({"GANG_LAYERS": str(GANG_LAYERS)} if backend == "gloo" else {}),
                **extra, TFK8S_TRAIN_STEPS=str(steps or TENSOR["gang_steps"]),
                TFK8S_LOG_EVERY="1",
                TFK8S_LEARNING_RATE="1e-4", TFK8S_SEED=str(TENSOR["seed"]),
                TFK8S_INPUT_MODE="per_host", TFK8S_INPUT_SHARDS="2",
                TFK8S_ATTENTION_IMPL="flash")


def _tensor_gangs(torch, fa, root, backend, gangs, also=()):
    """Each gang ``(name, family, mesh, env, sites, fault)`` through its
    family's ``train(env)`` with ``TFK8S_MESH`` set (over gloo at
    GANG_LAYERS layers; a planted fault one step), its first step against
    one process's (loss within PARALLEL_LOSS_ATOL, every gradient within
    FAMILY_GRAD_REL_L2, a planted fault beyond them); every rank launches
    each tensor-core flash kernel sites x layers x steps times (T5's three
    sites a layer), every forward at h / tensor heads. ``also``: runs of
    other families in the same launches, each with its own ``check(records,
    grads)``. Returns the launches of the one-process runs."""
    import importlib

    work = os.path.join(root, "build", "chip_smoke_tensor")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    steps, refs, runs = TENSOR["gang_steps"], {}, []
    total = dict.fromkeys(fa.KERNELS, 0)
    for name, family, mesh, extra, sites, fault in gangs:
        module = importlib.import_module(f"tfk8s_tpu_torch.models.{family}")
        env = _tensor_env(extra, backend)
        cfg = (module.tiny_config if "TFK8S_MODEL_PRESET" in env else module.base_config)()
        layers = family_layers(module, env)
        run_steps = 1 if fault else steps

        def flash(n_steps):
            return {**dict.fromkeys(fa.SIMT_KERNELS, 0),
                    **dict.fromkeys(fa.TENSOR_CORE_KERNELS, sites * layers * n_steps)}

        if family not in refs:
            losses, grads, one_ms, got, fresh = one_process(torch, fa, module, env)
            if got != flash(steps):
                raise AssertionError(f"{family} one process: flash launches {got}, "
                                     f"want {flash(steps)}")
            for k, v in got.items():
                total[k] += v if fresh else 0
            refs[family] = (losses[0], grads, one_ms)
        t = mesh["tensor"]
        runs.append(dict(name=name, out=os.path.join(work, name), want=refs[family][1],
                         whole=range(t), n=math.prod(mesh.values()), family=family,
                         mesh=mesh, fault=fault, launches=flash(run_steps),
                         heads=cfg.num_heads // t,
                         env=dict(_tensor_env(extra, backend, run_steps),
                                  TFK8S_MESH=json.dumps(mesh), FAMILY=family,
                                  **({"FAULT": fault} if fault else {}))))
    runs += [dict(run, out=os.path.join(work, run["name"])) for run in also]
    # the gangs of one size run in one launch, in turn
    for n in sorted({r["n"] for r in runs}):
        batch = [r for r in runs if r["n"] == n]
        t0 = time.perf_counter()
        results = _run_par_gangs(n, batch, backend)
        log(f"tensor: {len(batch)} gangs of {n} ranks in one launch ({backend}), "
            f"{time.perf_counter() - t0:.1f} s")
        for run in batch:
            name = run["name"]
            records, grads = results.pop(name)
            if "check" in run:
                run["check"](records, grads)
                continue
            loss, want, one_ms = refs[run["family"]]
            errs = _gang_check(f"{name} ({backend})", records, grads, loss, want,
                               run["launches"], fault=bool(run["fault"]), heads=[run["heads"]])
            del grads
            log(f"tensor gang {name} {json.dumps(run['mesh'])} ({backend}): {json.dumps({**errs, 'one_process_loss': loss, 'one_process_step_ms': one_ms, 'ranks': records})}")
    shutil.rmtree(work, ignore_errors=True)
    return total


def _dlrm(torch, fa):
    """``dlrm:train`` at its defaults (eight tables of 100,000 x 64, batch
    4,096, bf16 compute): TENSOR["dlrm_steps"] steps in one process, whose
    loss must fall, and the step on batches staged on the card with its
    profiler split. No flash kernel runs on this path. Returns its
    TENSOR_MESH gang, a run of the tensor phase's launch whose first update
    is held to the one process's (the whole gradient and each table's)."""
    from tfk8s_tpu_torch.models import dlrm

    none = dict.fromkeys(fa.KERNELS, 0)
    env = dict({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {},
               TFK8S_TRAIN_STEPS=str(TENSOR["dlrm_steps"]), TFK8S_LOG_EVERY="1",
               TFK8S_SEED=str(TENSOR["seed"]), TFK8S_INPUT_MODE="per_host")
    if DEVICE == "cpu":
        env.update(TFK8S_VOCAB_SIZES="1001,64,37", TFK8S_BATCH_SIZE="64", TFK8S_EMBED_DIM="16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, want, one_ms, launches = entry_steps(torch, fa, dlrm, env)
    summary = {"steps": len(losses), "losses": losses, "step_ms": one_ms,
               "wall_s": time.perf_counter() - t0,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "flash_launches": sum(launches.values())}
    log(f"tensor dlrm one process (no flash kernel runs on this path): {json.dumps(summary)}")
    if launches != none:
        raise AssertionError(f"dlrm: flash launches {launches} on a path with no attention")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"dlrm: the loss did not fall: {losses}")
    log(f"tensor dlrm staged step: {json.dumps(_staged_step(torch, dlrm.make_task(), 5))}")
    gang_env = dict(env, TFK8S_TRAIN_STEPS=str(TENSOR["gang_steps"]),
                    TFK8S_MESH=json.dumps(TENSOR_MESH), FAMILY="dlrm")

    def check(records, grads):
        errs = _gang_check("dlrm_tensor (gloo)", records, grads, losses[0], want, none)
        # the tables lead the optimizer's parameter order; each on its own
        vocab = env.get("TFK8S_VOCAB_SIZES")
        tables = range(len(vocab.split(",")) if vocab else len(dlrm.DEFAULT_VOCAB_SIZES))
        errs["worst_table_rel_l2"] = max(_grads_rel_l2({0: grads[t]}, {0: want[t]})
                                         for t in tables)
        if not errs["worst_table_rel_l2"] <= FAMILY_GRAD_REL_L2:
            raise AssertionError(f"dlrm_tensor: a table's gradient beyond "
                                 f"{FAMILY_GRAD_REL_L2}: {errs}")
        log(f"tensor gang dlrm_tensor {json.dumps(TENSOR_MESH)} (gloo): {json.dumps({**errs, 'one_process_step_ms': one_ms, 'ranks': records})}")

    return dict(name="dlrm_tensor", env=gang_env, want=want, n=2, check=check)


def phase_tensor(torch, fa, root):
    """The tensor axis (docstring phase 14): the flash kernels at a tensor
    rank's calls, each family's TENSOR_MESH gang over gloo (two ranks
    sharing the card) with the planted fault, and DLRM. Returns the
    launches of the one-process entry-point runs it drives here."""
    for i, (case_name, b, length, causal, lengths) in enumerate(TENSOR_KERNEL_CASES):
        log(f"case {case_name}:")
        check_case(fa, Case(case_name, b, length, length, 6, 64, torch.bfloat16,
                            causal=causal, lengths=lengths, seed=71 + i), iters=10, profile=True)
        torch.cuda.empty_cache()
    log("tensor: the gangs' steps are two gloo ranks sharing one card; they measure gloo's "
        "host round trips, not scaling")
    dlrm_gang = _dlrm(torch, fa)
    return _tensor_gangs(torch, fa, root, "gloo",
                         [(n, f, TENSOR_MESH, e, s, x) for n, f, e, s, x in TENSOR_GANGS],
                         also=[dlrm_gang])


# phase axes: the combined model axes at full width. Each gang runs its
# family's train(env) with TFK8S_MESH set, four gloo ranks sharing the
# card, for AXES["gang_steps"] steps (a planted fault's gang one), its
# first update's whole gradient (gathered over the mesh on rank 0) and
# loss against one process's run of the same entry point with flash
# attention, per_host input of two shards in both:
# (name, family, mesh, entry-point env, planted fault); every flash forward
# sees h / tensor heads, h / (tensor x sequence) inside Ulysses
AXES = dict(seed=91, gang_steps=2, fault_steps=1, gen_batch=8, gen_prompt=512, gen_tokens=32,
            gen_seed=93)
AXES_GPT = {"TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8"}
AXES_MOE = dict(AXES_GPT, TFK8S_NUM_EXPERTS="8")
AXES_BERT = {"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "8"}
AXES_GANGS = [
    ("gpt_fsdp_tensor", "gpt", {"fsdp": 2, "tensor": 2}, AXES_GPT, None),
    ("gpt_moe_expert_tensor", "gpt", {"expert": 2, "tensor": 2}, AXES_MOE, None),
    ("gpt_moe_expert_tensor_wo_unsummed", "gpt", {"expert": 2, "tensor": 2}, AXES_MOE,
     "expert_wo_unsummed"),
    ("bert_sequence_tensor", "bert", {"sequence": 2, "tensor": 2}, AXES_BERT, None),
    ("bert_sequence_tensor_heads_reversed", "bert", {"sequence": 2, "tensor": 2}, AXES_BERT,
     "ulysses_heads_reversed"),
    ("gpt_moe_fsdp_expert", "gpt", {"fsdp": 2, "expert": 2}, AXES_MOE, None),
    ("bert_fsdp_sequence", "bert", {"fsdp": 2, "sequence": 2}, AXES_BERT, None),
]
# over NCCL on four cards, a card a rank: gangs (a)-(c)
AXES_NCCL_GANGS = ("gpt_fsdp_tensor", "gpt_moe_expert_tensor", "bert_sequence_tensor")
# the flash kernels at the new calls: Ulysses beside tensor (BERT-base,
# 12 heads / (2 x 2)), and generate's prefill on a {"tensor": 2} rank
# (GPT-2-small, 6 of 12 heads) in both dtypes:
# (name, batch, length, heads, causal, dtype)
AXES_KERNEL_CASES = [
    ("ulysses_tensor_local", 8, 512, 3, False, "bfloat16"),
    ("prefill_tensor_rank_causal", 8, 512, 6, True, "bfloat16"),
    ("prefill_tensor_rank_causal", 8, 512, 6, True, "float32"),
]
AXES_GEN_DTYPES = ("float32", "bfloat16")
AXES_GEN_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["CHIP_SMOKE_ROOT"])
import torch

import chip_smoke
from tfk8s_tpu_torch.ops import flash_attention as fa
from tfk8s_tpu_torch.runtime.launcher import ProcessContext, initialize_distributed

env = dict(os.environ)
initialize_distributed(ProcessContext.from_env(env), env, backend=env["GANG_BACKEND"])
heads, flash_fwd = set(), fa.flash_fwd
fa.flash_fwd = lambda q, *a, **kw: heads.add(q.shape[2]) or flash_fwd(q, *a, **kw)
for dtype in chip_smoke.AXES_GEN_DTYPES:
    heads.clear()
    rank, model, prompts = chip_smoke._axes_gen_model(torch, dict(env, GEN_DTYPE=dtype))
    record = chip_smoke._axes_gen_run(torch, fa, model, prompts)
    print("RANK " + json.dumps({"rank": rank, "dtype": dtype, **record,
                                "heads": sorted(heads)}), flush=True)
    del model
"""


def moe_block_out(torch, mesh, env):
    """One MoE block of the MoE GPT (8 experts, top-1, capacity 1.25) of
    the gang ``env``'s preset on a fixed ``cfg.dtype`` input ``[8, seq,
    embed]`` (``env``'s seq): over ``mesh`` each
    rank holds its experts' rows and tensor blocks of the whole block's
    parameters (drawn from the AXES seed); ``mesh`` a device: the whole
    block in one process. Its output, float32 on the host."""
    from tfk8s_tpu_torch.models import gpt
    from tfk8s_tpu_torch.models.transformer import mesh_device
    from tfk8s_tpu_torch.parallel.moe import ExpertShard, SwitchMoeBlock
    from tfk8s_tpu_torch.parallel.tensor_parallel import (TensorShard, named_splits,
                                                          shard_state_dict, tensor_splits)

    tiny = env.get("TFK8S_MODEL_PRESET") == "tiny"
    cfg = (gpt.tiny_config if tiny else gpt.base_config)(num_experts=8)
    whole = SwitchMoeBlock(cfg, 8)
    whole.init_weights(torch.Generator().manual_seed(AXES["seed"]))
    block = SwitchMoeBlock(cfg, 8, experts=ExpertShard.of(mesh), tp=TensorShard.of(mesh))
    block.load_state_dict(shard_state_dict(whole.state_dict(),
                                           named_splits(block, "expert_splits"),
                                           tensor_splits(block)))
    device = mesh_device(mesh)
    gen = torch.Generator().manual_seed(AXES["seed"])
    x = torch.randn(8, int(env["TFK8S_SEQ_LEN"]), cfg.embed_dim, generator=gen)
    x = x.to(cfg.dtype).to(device)
    with torch.no_grad():
        y, _ = block.to(device)(x)
    return y.float().cpu()


def _axes_env(extra, steps, backend="gloo"):
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    return dict({"TFK8S_MODEL_PRESET": "tiny"} if tiny else {},
                **({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {}),
                **({"GANG_LAYERS": str(GANG_LAYERS)} if backend == "gloo" else {}),
                **extra, TFK8S_TRAIN_STEPS=str(steps), TFK8S_LOG_EVERY="1",
                TFK8S_LEARNING_RATE="1e-4", TFK8S_SEED=str(AXES["seed"]),
                TFK8S_INPUT_MODE="per_host", TFK8S_INPUT_SHARDS="2")


def _axes_gangs(torch, fa, root, backend, gangs):
    """Each gang ``(name, family, mesh, env, fault)`` through its
    family's ``train(env)`` (Ulysses by the policy where the mesh has a
    sequence axis, the flash kernels inside; flash elsewhere; over gloo at
    GANG_LAYERS layers), its first
    step against one process's with flash (PARALLEL_LOSS_ATOL,
    FAMILY_GRAD_REL_L2; a planted fault beyond them), every rank launching
    each tensor-core kernel layers x steps times, every forward at the
    heads the layout gives. The gangs of four ranks run in one launch, in
    turn (:func:`_run_par_gangs`). Returns the launches of the one-process
    runs."""
    import importlib

    work = os.path.join(root, "build", "chip_smoke_axes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    refs, total, runs, checks = {}, dict.fromkeys(fa.KERNELS, 0), [], {}
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    for name, family, mesh, extra, fault in gangs:
        module = importlib.import_module(f"tfk8s_tpu_torch.models.{family}")
        steps = AXES["fault_steps" if fault else "gang_steps"]
        cfg = (module.tiny_config if tiny else module.base_config)()
        layers = family_layers(module, _axes_env(extra, steps, backend))
        key = (family, extra.get("TFK8S_NUM_EXPERTS"))
        if key not in refs:
            env = _axes_env(dict(extra, TFK8S_ATTENTION_IMPL="flash"), AXES["gang_steps"],
                            backend)
            losses, grads, one_ms, got, fresh = one_process(torch, fa, module, env)
            want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
                    **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * AXES["gang_steps"])}
            if got != want:
                raise AssertionError(f"{key} one process: flash launches {got}, want {want}")
            for k, v in got.items():
                total[k] += v if fresh else 0
            refs[key] = (losses[0], grads, one_ms)
        impl = "auto" if "sequence" in mesh else "flash"
        # an expert x tensor gang also runs one MoE block on a fixed input:
        # the unsummed wo blocks halve its output, which the first update
        # barely feels (the block's output is small beside the residual)
        block = "expert" in mesh and "tensor" in mesh
        env = dict(_axes_env(dict(extra, TFK8S_ATTENTION_IMPL=impl), steps, backend),
                   TFK8S_MESH=json.dumps(mesh), FAMILY=family, WHOLE_GRADS="1",
                   **({"FAULT": fault} if fault else {}), **({"MOE_BLOCK": "1"} if block else {}))
        runs.append(dict(name=name, env=env, out=os.path.join(work, name),
                         want=refs[key][1], n=math.prod(mesh.values())))
        checks[name] = (mesh, key, fault, block, env, {
            **dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * steps)},
            cfg.num_heads // mesh.get("tensor", 1) // mesh.get("sequence", 1))
    one_block = None
    for n in sorted({r["n"] for r in runs}):
        t0 = time.perf_counter()
        batch = [r for r in runs if r["n"] == n]
        results = _run_par_gangs(n, batch, backend)
        log(f"axes: {len(batch)} gangs of {n} ranks in one launch, {time.perf_counter() - t0:.1f} s")
        for run in batch:
            name = run["name"]
            mesh, key, fault, block, env, launches, heads = checks[name]
            records, grads = results.pop(name)
            loss, want_grads, one_ms = refs[key]
            block_rel = None
            if block:
                if one_block is None:
                    one_block = moe_block_out(torch, DEVICE, env)
                block_rel = _rel_l2(torch.load(f"{run['out']}-moe.pt"), one_block)
            errs = _gang_check(f"{name} ({backend})", records, grads, loss, want_grads,
                               launches, fault=bool(fault), heads=[heads],
                               block_rel_l2=block_rel)
            del grads
            log(f"axes gang {name} {json.dumps(mesh)} ({backend}): {json.dumps({**errs, 'one_process_loss': loss, 'one_process_step_ms': one_ms, 'ranks': records})}")
    shutil.rmtree(work, ignore_errors=True)
    return total


def _axes_gen_model(torch, env):
    """``(rank, model, prompts)``: GPT-2-small (at ``env``'s GANG_LAYERS
    depth) in ``env["GEN_DTYPE"]`` with flash attention, its initial
    parameters those of one process at
    AXES["gen_seed"], over ``env``'s mesh (a process group's
    ``TFK8S_MESH``, else one process), and the AXES prompts on the card."""
    import numpy as np

    from tfk8s_tpu_torch.models import gpt
    from tfk8s_tpu_torch.models.transformer import init_params
    from tfk8s_tpu_torch.parallel.tensor_parallel import init_sharded
    from tfk8s_tpu_torch.runtime import train as ttrain

    preset = gpt.tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else gpt.base_config
    cfg = preset(dtype=getattr(torch, env["GEN_DTYPE"]), attention_impl="flash",
                 **({"num_layers": int(env["GANG_LAYERS"])} if env.get("GANG_LAYERS") else {}))
    _ctx, device, mesh = ttrain.join_mesh(dict(env, TFK8S_DEVICE=env.get("TFK8S_DEVICE",
                                                                          DEVICE)))
    model = init_sharded(lambda m: gpt.GPTLM(cfg, mesh=m), init_params,
                         torch.Generator().manual_seed(AXES["gen_seed"]), mesh).to(device)
    b, plen = AXES["gen_batch"], min(AXES["gen_prompt"], cfg.max_len // 2)
    prompts = np.random.default_rng(AXES["gen_seed"]).integers(1, cfg.vocab_size, (b, plen))
    return mesh.rank, model.eval(), torch.from_numpy(prompts).to(device)


def _axes_gen_run(torch, fa, model, prompts):
    """``gpt.greedy_generate`` of AXES["gen_tokens"] tokens: the tokens,
    ms, flash launches (counts zeroed just before) and peak memory."""
    from tfk8s_tpu_torch.models import gpt

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    tokens = gpt.greedy_generate(model.cfg, model, prompts, AXES["gen_tokens"])
    if cuda:
        torch.cuda.synchronize()
    return {"tokens": tokens.tolist(), "ms": (time.perf_counter() - t0) * 1e3,
            "launches": dict(fa.LAUNCHES),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}


def _axes_generate(torch, fa, root):
    """GPT-2-small ``greedy_generate`` (8 prompts of 512, 32 tokens, flash
    prefill; GANG_LAYERS layers) on a ``{"tensor": 2}`` gang of two gloo
    ranks sharing the
    card against one process, in float32 then bfloat16 (one launch of the
    gang): in float32 the tokens equal except at a near tie
    (``_greedy_check``: the serving phases' rule, against the one
    process's full forward), in bfloat16 the share of equal tokens is
    printed. Every rank's prefill launches the flash forward once a layer
    at 6 heads. Returns the one-process runs' launches."""
    import socket

    total = dict.fromkeys(fa.KERNELS, 0)
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    base = dict({"TFK8S_MODEL_PRESET": "tiny"} if tiny else {}, GANG_LAYERS=str(GANG_LAYERS))
    ones = {}
    for dtype in AXES_GEN_DTYPES:
        _rank, model, prompts = _axes_gen_model(torch, dict(base, GEN_DTYPE=dtype))
        one = _axes_gen_run(torch, fa, model, prompts)
        for k, v in one["launches"].items():
            total[k] += v
        fwd = "flash_fwd_wgmma" if dtype == "bfloat16" else "flash_fwd_simt"
        want = {**dict.fromkeys(fa.KERNELS, 0), fwd: model.cfg.num_layers}
        if one["launches"] != want:
            raise AssertionError(f"generate {dtype} one process: launches {one['launches']}, "
                                 f"want {want}")
        # the float32 model stays for the tie rule's full forwards
        ones[dtype] = (model if dtype == "float32" else None, prompts, one, want,
                       model.cfg.num_heads // 2)
        del model
        torch.cuda.empty_cache()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = [subprocess.Popen(
        [sys.executable, "-c", AXES_GEN_WORKER], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **base, CHIP_SMOKE_ROOT=root, TFK8S_DISTRIBUTED="1",
                 TFK8S_NUM_PROCESSES="2", TFK8S_PROCESS_ID=str(r),
                 TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", GANG_BACKEND="gloo",
                 TFK8S_MESH=json.dumps({"tensor": 2}),
                 **({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {})))
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=PARALLEL["timeout_s"])[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        if p.returncode != 0 or len(lines) != len(AXES_GEN_DTYPES):
            raise AssertionError(f"generate rank {r} exited {p.returncode}:\n{text[-3000:]}")
        records += [json.loads(ln[5:]) for ln in lines]
    for dtype, (model, prompts, one, want, heads) in ones.items():
        mine = [rec for rec in records if rec["dtype"] == dtype]
        for rec in mine:
            if rec["launches"] != want or rec["heads"] != [heads]:
                raise AssertionError(f"generate {dtype} rank {rec['rank']}: launches "
                                     f"{rec['launches']} heads {rec['heads']}, want {want} "
                                     f"at {heads}")
            if rec["tokens"] != mine[0]["tokens"]:
                raise AssertionError(f"generate {dtype}: the tensor ranks' tokens differ")
        gang_tokens = mine[0]["tokens"]
        same = sum(a == b for x, y in zip(one["tokens"], gang_tokens) for a, b in zip(x, y))
        summary = {"dtype": dtype, "one_process_ms": one["ms"],
                   "one_process_peak_gib": one["peak_gib"],
                   "equal_token_share": same / sum(len(x) for x in one["tokens"]),
                   "ranks": [{k: r[k] for k in ("rank", "ms", "peak_gib", "heads")}
                             for r in mine]}
        if model is not None:
            checked, ties = _greedy_check(torch, model, [p.cpu().numpy() for p in prompts],
                                          one["tokens"], others=(gang_tokens,))
            summary.update(tokens_checked=checked, near_ties=ties)
        log(f"axes generate {{\"tensor\": 2}} (gloo): {json.dumps(summary)}")
    del ones
    torch.cuda.empty_cache()
    return total


def phase_axes(torch, fa, root):
    """The combined model axes (docstring phase 15): the flash kernels at
    the new calls, the gangs of AXES_GANGS over gloo (four ranks sharing
    the card) with their planted faults, and tensor-parallel generation.
    Returns the launches of the one-process runs it drives here."""
    for i, (case_name, b, length, heads, causal, dtype) in enumerate(AXES_KERNEL_CASES):
        log(f"case {case_name} {dtype}:")
        check_case(fa, Case(case_name, b, length, length, heads, 64, getattr(torch, dtype),
                            causal=causal, seed=95 + i), iters=10, profile=True)
        torch.cuda.empty_cache()
    log("axes: the gangs' steps are four gloo ranks sharing one card; they measure gloo's "
        "host round trips, not scaling")
    total = _axes_gangs(torch, fa, root, "gloo", AXES_GANGS)
    for k, v in _axes_generate(torch, fa, root).items():
        total[k] += v
    return total


def phase_nccl(torch, gpt, fa, gn, root):
    """The pods of POD_NCCL_JOBS that fit the cards, started by the entry
    point a card a rank, and the gangs of phase 13 over NCCL, a card a
    rank, where the machine has two cards or more, and the pipelined gangs of PIPELINE_NCCL_GANGS
    that fit its cards; with four the tensor gangs of TENSOR_NCCL_GANGS,
    the combined-axes gangs of AXES_NCCL_GANGS and the pipeline-axes gangs
    of PIPELINE_AXES_NCCL_GANGS; else one line says why they were skipped
    (NCCL will not put two ranks on one card)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"nccl: gangs skipped: {cards} card visible; NCCL will not put two ranks on "
            "one card, so the gangs ran over gloo only (phases parallel, tensor, axes "
            "and pipeline)")
        return
    _pod_nccl(torch, fa, root, cards)
    if cards >= 4:
        _operator_nccl(torch, fa)
    _parallel_gangs(torch, gpt, fa, root, "nccl")
    fits = [g for g in PIPELINE_NCCL_GANGS if math.prod(g[1].values()) <= cards]
    _pipeline_gangs(torch, fa, gn, root, "nccl", fits, _pipeline_reference(torch, fa, gn)[0])
    if cards < 4:
        log(f"nccl: tensor and combined-axes gangs and the four-rank pipelined gangs "
            f"skipped: {cards} cards, they need 4")
        return
    _tensor_gangs(torch, fa, root, "nccl",
                  [(n, f, m, e, s, None) for n, f, m, e, s in TENSOR_NCCL_GANGS])
    _axes_gangs(torch, fa, root, "nccl", [g for g in AXES_GANGS if g[0] in AXES_NCCL_GANGS])
    _pipeline_axes_gangs(torch, fa, gn, root, "nccl", [
        g for g in PIPELINE_AXES_GANGS if g[0] in PIPELINE_AXES_NCCL_GANGS])


# phase pipeline: the pipelined BERT-MLM (GPipe) at BERT-base width with the
# reference's defaults; the gangs' first update against one process's
PIPELINE = dict(seed=81, one_steps=10, gang_steps=2)
PIPELINE_ENV = {"TFK8S_SEQ_LEN": "128", "TFK8S_BATCH_SIZE": "64", "TFK8S_NUM_MICRO": "4",
                "TFK8S_NUM_LAYERS": "12", "TFK8S_LEARNING_RATE": "1e-3",
                "TFK8S_INPUT_MODE": "replicated", "TFK8S_LOG_EVERY": "1"}
# (name, mesh, extra env, planted fault): two ranks sharing the card, one
# stage a slice, so the stage send crosses the slice boundary
PIPELINE_GANGS = [
    ("pipeline2_two_slices", {"pipeline": 2}, {"TFK8S_NUM_SLICES": "2"}, None),
    ("pipeline2_record_shifted", {"pipeline": 2}, {"TFK8S_NUM_SLICES": "2"}, "record_shifted"),
]
# over NCCL, a card a rank: (name, mesh, extra env, fault)
PIPELINE_NCCL_GANGS = [
    ("pipeline2", {"pipeline": 2}, {}, None),
    ("pipeline2_data2", {"pipeline": 2, "data": 2}, {}, None),
    ("pipeline4", {"pipeline": 4}, {}, None),
]


def _pipeline_env(steps, backend="nccl"):
    """The pipelined entry point's env: PIPELINE_ENV's 12 layers, or over
    gloo GANG_LAYERS (a layer a stage on ``{"pipeline": 2}``)."""
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    return {**PIPELINE_ENV,
            **({"TFK8S_MODEL_PRESET": "tiny", "TFK8S_NUM_LAYERS": "4"} if tiny else {}),
            **({"TFK8S_NUM_LAYERS": str(GANG_LAYERS)} if backend == "gloo" else {}),
            **({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {}),
            "TFK8S_TRAIN_STEPS": str(steps), "TFK8S_SEED": str(PIPELINE["seed"])}


def _pipeline_reference(torch, fa, gn, steps=None, backend="nccl"):
    """One process's ``pipelined:train`` (one stage holding every layer;
    ``backend`` picks the depth, :func:`_pipeline_env`):
    ``(first loss, first update's gradient, step ms)`` and its summary,
    with no kernel launched (counts zeroed just before it)."""
    from tfk8s_tpu_torch.models import pipelined

    steps = steps or PIPELINE["gang_steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gn.reset_launches()
    t0 = time.perf_counter()
    losses, want, one_ms, launches, _fresh = one_process(torch, fa, pipelined,
                                                        _pipeline_env(steps, backend))
    summary = {"steps": len(losses), "losses": losses, "step_ms": one_ms,
               "wall_s": time.perf_counter() - t0,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "flash_launches": launches, "group_norm_launches": dict(gn.LAUNCHES)}
    if any(launches.values()) or any(gn.LAUNCHES.values()):
        raise AssertionError(f"pipelined one process: kernel launches {summary}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pipelined one process: losses {losses}")
    return (losses[0], want, one_ms), summary


def _pipeline_stages(mesh):
    """``assemble`` for ``_run_par_gangs``: the whole gradient in the one
    process's parameter order from the ranks' (each ``[embedding...,
    its stage's layers..., final norm...]``): the embedding and the final
    norm from rank 0, each stage's layers from its first data rank."""
    data = mesh.get("data", 1)

    def assemble(parts):
        stages = [parts[s * data] for s in range(mesh["pipeline"])]
        return stages[0][:2] + [g for p in stages for g in p[2:-2]] + stages[0][-2:]

    return assemble


def _pipeline_gangs(torch, fa, gn, root, backend, gangs, reference):
    """Each gang ``(name, mesh, extra env, fault)`` through
    ``pipelined:train`` for PIPELINE["gang_steps"] steps (a planted fault's
    one; over gloo at GANG_LAYERS layers, the gangs of one size in one
    launch), its first update against one process's ``reference`` (loss
    within PARALLEL_LOSS_ATOL, the whole gradient within
    FAMILY_GRAD_REL_L2, a planted fault beyond them; ``reference``: its
    first loss, gradient and step ms at the same depth); no rank may launch
    a flash or GroupNorm kernel."""
    work = os.path.join(root, "build", "chip_smoke_pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    loss, want, one_ms = reference
    none = dict.fromkeys(fa.KERNELS, 0)
    runs = []
    for name, mesh, extra, fault in gangs:
        steps = 1 if fault and backend == "gloo" else PIPELINE["gang_steps"]
        env = dict(_pipeline_env(steps, backend), TFK8S_MESH=json.dumps(mesh),
                   FAMILY="pipelined", **extra, **({"FAULT": fault} if fault else {}))
        runs.append(dict(name=name, env=env, out=os.path.join(work, name), want=want,
                         assemble=_pipeline_stages(mesh), mesh=mesh, extra=extra, fault=fault,
                         n=math.prod(mesh.values())))
    # over gloo the gangs of one size share a launch; over NCCL each has its own
    launches = ([[r for r in runs if r["n"] == n] for n in sorted({r["n"] for r in runs})]
                if backend == "gloo" else [[r] for r in runs])
    for batch in launches:
        t0 = time.perf_counter()
        results = _run_par_gangs(batch[0]["n"], batch, backend)
        wall = time.perf_counter() - t0
        log(f"pipeline: {len(batch)} gangs of {batch[0]['n']} ranks in one launch ({backend}), "
            f"{wall:.1f} s")
        for run in batch:
            name, mesh = run["name"], run["mesh"]
            records, grads = results.pop(name)
            errs = _gang_check(f"{name} ({backend})", records, grads, loss, want, none,
                               fault=bool(run["fault"]))
            for r in records:
                if any(r["gn_launches"].values()):
                    raise AssertionError(f"{name}: rank {r['rank']} GroupNorm launches "
                                         f"{r['gn_launches']}")
            del grads
            log(f"pipeline gang {name} {json.dumps(mesh)} {json.dumps(run['extra'])} ({backend}): {json.dumps({**errs, 'one_process_loss': loss, 'one_process_step_ms': one_ms, 'launch_wall_s': wall, 'ranks': records})}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_pipeline(torch, fa, gn, root):
    """The pipeline axis (docstring phase 17): one process's
    ``pipelined:train`` at BERT-base width, then the PIPELINE_GANGS over
    gloo (two ranks sharing the card) with the planted fault. No kernel
    runs on this path: returns its launches, all zero."""
    from tfk8s_tpu_torch.models import bert, pipelined

    summary = _pipeline_reference(torch, fa, gn, PIPELINE["one_steps"])[1]
    log(f"pipeline one process (one stage, no kernel runs on this path): {json.dumps(summary)}")
    # the same step on batches staged on the card, and BERT's unpipelined
    # stack on the same batch: what the schedule costs in one process
    env = _pipeline_env(1)
    cfg = (bert.tiny_config if "TFK8S_MODEL_PRESET" in env else bert.base_config)(
        num_layers=int(env["TFK8S_NUM_LAYERS"]))
    shape = dict(seq_len=int(env["TFK8S_SEQ_LEN"]), batch_size=int(env["TFK8S_BATCH_SIZE"]))
    for name, task in (("pipelined", pipelined.make_task(
            DEVICE, cfg=cfg, num_micro=int(env["TFK8S_NUM_MICRO"]), **shape)),
            ("bert", bert.make_task(cfg=cfg, **shape))):
        log(f"pipeline staged step, {name}: {json.dumps(_staged_step(torch, task, 5))}")
    log("pipeline: the gangs' steps are two gloo ranks sharing one card; they measure gloo's "
        "host round trips, not scaling")
    # the gangs' one process: GANG_LAYERS layers, no kernel either
    gang_reference, gang_summary = _pipeline_reference(torch, fa, gn, backend="gloo")
    log(f"pipeline gangs' one process ({GANG_LAYERS} layers): {json.dumps(gang_summary)}")
    _pipeline_gangs(torch, fa, gn, root, "gloo", PIPELINE_GANGS, gang_reference)
    return {**summary["flash_launches"], **summary["group_norm_launches"]}


# phase pipeline_axes: the pipeline axis beside the other axes at full
# width, each gang through its entry point with TFK8S_MESH set, four gloo
# ranks sharing the card, all in one launch; its first update's whole
# gradient and loss against one process's run of the same entry point:
# (name, family, mesh, entry-point env, planted fault)
PIPELINE_AXES_GANGS = [
    ("pipelined_pipeline_tensor", "pipelined", {"pipeline": 2, "tensor": 2}, {}, None),
    ("pipelined_pipeline_tensor_row_unsummed", "pipelined", {"pipeline": 2, "tensor": 2}, {},
     "row_unsummed"),
    ("pipelined_pipeline_fsdp", "pipelined", {"pipeline": 2, "fsdp": 2}, {}, None),
    ("pipelined_pipeline_sequence", "pipelined", {"pipeline": 2, "sequence": 2}, {}, None),
    ("pipelined_pipeline_sequence_counted", "pipelined", {"pipeline": 2, "sequence": 2}, {},
     "sequence_counted"),
    ("gpt_pipeline_tensor", "gpt", {"pipeline": 2, "tensor": 2}, AXES_GPT, None),
    ("gpt_moe_pipeline_expert", "gpt", {"pipeline": 2, "expert": 2}, AXES_MOE, None),
    ("dlrm_fsdp_tensor", "dlrm", {"fsdp": 2, "tensor": 2}, {}, None),
]
# over NCCL on four cards, a card a rank: gangs (a) and (d)
PIPELINE_AXES_NCCL_GANGS = ("pipelined_pipeline_tensor", "gpt_pipeline_tensor")


def _pipeline_axes_env(family, extra, steps, backend="gloo"):
    """A gang's (or its one process's) entry-point env: the pipelined
    family's PIPELINE_ENV, GPT's AXES env with flash attention (both over
    gloo at GANG_LAYERS layers), DLRM's defaults (cut on the CPU
    rehearsal)."""
    if family == "pipelined":
        return _pipeline_env(steps, backend)
    if family == "gpt":
        return _axes_env(dict(extra, TFK8S_ATTENTION_IMPL="flash"), steps, backend)
    env = dict({"TFK8S_DEVICE": "cpu", "TFK8S_VOCAB_SIZES": "1001,64,37",
                "TFK8S_BATCH_SIZE": "64", "TFK8S_EMBED_DIM": "16"} if DEVICE == "cpu" else {},
               TFK8S_TRAIN_STEPS=str(steps), TFK8S_LOG_EVERY="1",
               TFK8S_SEED=str(TENSOR["seed"]), TFK8S_INPUT_MODE="per_host",
               TFK8S_INPUT_SHARDS="2")
    return dict(env, **extra)


def _pipeline_axes_gangs(torch, fa, gn, root, backend, gangs):
    """Each gang ``(name, family, mesh, env, fault)`` through its entry
    point (AXES["gang_steps"] steps; a planted fault's one), all of one
    launch, its first update against one process's (PARALLEL_LOSS_ATOL,
    FAMILY_GRAD_REL_L2; a planted fault beyond them; DLRM's tables each
    within the bound too); GPT's ranks launch each tensor-core flash
    kernel layers x steps times at h / tensor heads, the pipelined and
    DLRM ranks no kernel at all. Returns the launches of the one-process
    runs and of every rank."""
    import importlib

    work = os.path.join(root, "build", "chip_smoke_pipeline_axes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    refs, total, runs = {}, dict.fromkeys(fa.KERNELS, 0), []
    none = dict.fromkeys(fa.KERNELS, 0)
    for name, family, mesh, extra, fault in gangs:
        module = importlib.import_module(f"tfk8s_tpu_torch.models.{family}")
        steps = AXES["fault_steps" if fault else "gang_steps"]
        # flash sites a step (one a layer in GPT; none on the other paths)
        sites, heads = 0, None
        if family == "gpt":
            cfg = (module.tiny_config if "TFK8S_MODEL_PRESET" in _axes_env({}, 1)
                   else module.base_config)()
            sites = family_layers(module, _pipeline_axes_env(family, extra, steps, backend))
            heads = [cfg.num_heads // mesh.get("tensor", 1)]
        launches = {**none, **dict.fromkeys(fa.TENSOR_CORE_KERNELS, sites * steps)}
        key = (family, extra.get("TFK8S_NUM_EXPERTS"))
        if key not in refs:
            gn.reset_launches()
            env = _pipeline_axes_env(family, extra, AXES["gang_steps"], backend)
            losses, grads, one_ms, got, fresh = one_process(torch, fa, module, env)
            want = {**none, **dict.fromkeys(fa.TENSOR_CORE_KERNELS, sites * AXES["gang_steps"])}
            if got != want or any(gn.LAUNCHES.values()):
                raise AssertionError(f"{key} one process: launches {got} "
                                     f"{dict(gn.LAUNCHES)}, want {want}")
            for k, v in got.items():
                total[k] += v if fresh else 0
            refs[key] = (losses[0], grads, one_ms)
        env = dict(_pipeline_axes_env(family, extra, steps, backend),
                   TFK8S_MESH=json.dumps(mesh),
                   FAMILY=family, WHOLE_GRADS="1", **({"FAULT": fault} if fault else {}))
        runs.append(dict(name=name, env=env, out=os.path.join(work, name), want=refs[key][1],
                         key=key, mesh=mesh, fault=fault, launches=launches, heads=heads))
    t0 = time.perf_counter()
    n = math.prod(runs[0]["mesh"].values())
    results = _run_par_gangs(n, runs, backend)
    log(f"pipeline_axes: {len(runs)} gangs of {n} ranks in one launch ({backend}), "
        f"{time.perf_counter() - t0:.1f} s")
    for run in runs:
        name = run["name"]
        records, grads = results.pop(name)
        loss, want, one_ms = refs[run["key"]]
        errs = _gang_check(f"{name} ({backend})", records, grads, loss, want, run["launches"],
                           fault=bool(run["fault"]), heads=run["heads"])
        if run["key"][0] == "dlrm":  # the tables lead the parameter order
            vocab = run["env"].get("TFK8S_VOCAB_SIZES")
            tables = len(vocab.split(",")) if vocab else 8
            errs["worst_table_rel_l2"] = max(_grads_rel_l2({0: grads[t]}, {0: want[t]})
                                             for t in range(tables))
            if not errs["worst_table_rel_l2"] <= FAMILY_GRAD_REL_L2:
                raise AssertionError(f"{name}: a table's gradient beyond "
                                     f"{FAMILY_GRAD_REL_L2}: {errs}")
        for r in records:
            if any(r["gn_launches"].values()):
                raise AssertionError(f"{name}: rank {r['rank']} GroupNorm launches "
                                     f"{r['gn_launches']}")
            for k, v in r["launches"].items():
                total[k] += v
        del grads
        log(f"pipeline_axes gang {name} {json.dumps(run['mesh'])} ({backend}): {json.dumps({**errs, 'one_process_loss': loss, 'one_process_step_ms': one_ms, 'ranks': records})}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def phase_pipeline_axes(torch, fa, gn, root):
    """The pipeline axis beside fsdp, expert, sequence and tensor
    (docstring phase 18): the gangs of PIPELINE_AXES_GANGS over gloo (four
    ranks sharing the card) with their planted faults. Returns the
    launches of its one-process runs and gangs."""
    log("pipeline_axes: the gangs' steps are four gloo ranks sharing one card; they measure "
        "gloo's host round trips, not scaling")
    return _pipeline_axes_gangs(torch, fa, gn, root, "gloo", PIPELINE_AXES_GANGS)


# the profile phase: TRAIN_ENV's run with a trace of steps 4-8 (the
# reference's window: 3 skipped, 5 traced), then 8 steps logged every 4
# scanned 4 a dispatch against per-step dispatch
PROFILE = dict(skip=3, traced=5, scan=4, scan_steps=8, scan_log_every=4, top=10)
# the flash kernels' names in a trace
TRACE_KERNELS = {"flash_fwd_wgmma": "tfk8s_fwd_wgmma_kernel",
                 "flash_bwd_dsum": "tfk8s_dsum_kernel",
                 "flash_bwd_dq_wgmma": "tfk8s_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma": "tfk8s_dkv_wgmma_kernel"}
# the text phase: a BPE tokenizer trained on these files of the checkout,
# rows of TRAIN_ENV's length, GPT-2-small from the shards with the
# tokenizer's vocabulary, checkpointed to a gs:// location under a fake
# root in build/, resumed once, then a greedy continuation decoded
TEXT = dict(files=("README.md", "SURVEY.md", "PAPER.md"), vocab=512, shards=2, first_steps=6,
            steps=12, gen=16, bucket="chip-smoke-text", key="gpt2-small/run",
            prompt="The controller")


def _trace_split(path):
    """Each ``ProfilerStep`` span of a Chrome trace: its length, the
    device activities it launched (a kernel whose launch the trace lacks
    counts by its own start), their union (device busy), the idle share,
    and the launches and ms of each device operation by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("ProfilerStep#")), key=lambda e: e["ts"])
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    steps = []
    for span in spans:
        lo, hi = span["ts"], span["ts"] + span["dur"]
        mine = [e for e in device
                if lo <= launched.get(e.get("args", {}).get("correlation"), e["ts"]) < hi]
        busy, cur = 0.0, None
        for start, end in sorted((e["ts"], e["ts"] + e["dur"]) for e in mine):
            if cur is None or start > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [start, end]
            else:
                cur[1] = max(cur[1], end)
        busy += 0.0 if cur is None else cur[1] - cur[0]
        ops = {}
        for e in mine:
            n, ms = ops.get(e["name"], (0, 0.0))
            ops[e["name"]] = (n + 1, ms + e["dur"] * 1e-3)
        steps.append({
            "name": span["name"], "span_ms": span["dur"] * 1e-3, "busy_ms": busy * 1e-3,
            "kernel_ms": sum(e["dur"] for e in mine) * 1e-3,
            "idle": 1.0 - busy / span["dur"], "ops": ops,
            "by_launch": sum(e.get("args", {}).get("correlation") in launched for e in mine),
            "activities": len(mine),
        })
    return steps


def _op_group(name):
    """The part of the dense step a device operation belongs to: the
    flash kernels, the float32 GEMMs (the tied head, TF32 off), the other
    GEMMs (bf16; cuBLAS names them ``nvjet`` or ``gemm``), the optimizer,
    copies, or the rest."""
    low = name.lower()
    if any(k in name for k in TRACE_KERNELS.values()):
        return "flash"
    if "sgemm" in low or "gemm_f32f32" in low:
        return "gemm_f32"
    if "gemm" in low or "nvjet" in low or "xmma" in low or "cublas" in low:
        return "gemm_bf16"
    if "adam" in low or "multi_tensor_apply" in low:
        return "optimizer"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def phase_profile(torch, gpt, fa, root):
    """``gpt:train`` at TRAIN_ENV with ``TFK8S_PROFILE_DIR``: the trace's
    five step spans each hold 12 launches of every tensor-core flash kernel;
    the dense step split by the trace. Then 8 steps scanned 4 a dispatch
    against per-step dispatch: equal histories. Returns the launches."""
    layers = gpt.base_config().num_layers
    prof_dir = os.path.join(root, "build", "chip_smoke_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    launches = dict.fromkeys(fa.KERNELS, 0)

    def run(env):
        fa.reset_launches()
        history = gpt.train(env)
        torch.cuda.synchronize()
        for k, v in fa.LAUNCHES.items():
            launches[k] += v
        return history, dict(fa.LAUNCHES)

    history, got = run(dict(TRAIN_ENV, TFK8S_PROFILE_DIR=prof_dir))
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * TRAIN_STEPS)}
    if got != want:
        raise AssertionError(f"profiled run: flash launches {got}, want {want}")
    paths = glob.glob(os.path.join(prof_dir, "*.json"))
    if len(paths) != 1:
        raise AssertionError(f"want one trace under {prof_dir}, found {paths}")
    steps = _trace_split(paths[0])
    names = [s["name"] for s in steps]
    first = PROFILE["skip"] + 1
    window = [f"ProfilerStep#{i}" for i in range(first, first + PROFILE["traced"])]
    if names != window:
        raise AssertionError(f"trace spans {names}, want {window}")
    for s in steps:
        counts = {k: sum(n for op, (n, _ms) in s["ops"].items() if kname in op)
                  for k, kname in TRACE_KERNELS.items()}
        if counts != dict.fromkeys(TRACE_KERNELS, layers):
            raise AssertionError(f"{s['name']}: flash kernels {counts}, want {layers} each")
    # the host's step time over the window, from the history's clock
    at = {h["step"]: h["step"] / h["steps_per_s"] for h in history}
    host_ms = (at[first + PROFILE["traced"] - 1] - at[first - 1]) / PROFILE["traced"] * 1e3
    busy_ms = sum(s["busy_ms"] for s in steps) / len(steps)
    ops = {}
    for s in steps:
        for op, (n, ms) in s["ops"].items():
            m = ops.setdefault(op, [0, 0.0])
            m[0] += n / len(steps)
            m[1] += ms / len(steps)
    groups = {}
    for op, (n, ms) in ops.items():
        g = groups.setdefault(_op_group(op), [0, 0.0])
        g[0] += n
        g[1] += ms
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:PROFILE["top"]]
    log("profile: " + json.dumps({
        "trace": os.path.relpath(paths[0], root),
        "steps": [{k: s[k] for k in ("name", "span_ms", "busy_ms", "kernel_ms", "idle",
                                     "activities", "by_launch")} for s in steps],
        "span_ms_mean": sum(s["span_ms"] for s in steps) / len(steps),
        "busy_ms_mean": busy_ms, "idle_mean": sum(s["idle"] for s in steps) / len(steps),
        "host_step_ms": host_ms,
        "groups_ms_a_step": {g: {"launches": n, "ms": ms} for g, (n, ms) in groups.items()},
        "top": [{"op": op[:100], "launches": n, "ms": ms} for op, (n, ms) in top],
    }))

    def scan_run(scan):
        env = dict(TRAIN_ENV, TFK8S_TRAIN_STEPS=str(PROFILE["scan_steps"]),
                   TFK8S_LOG_EVERY=str(PROFILE["scan_log_every"]))
        if scan > 1:
            env["TFK8S_SCAN_STEPS"] = str(scan)
        t0 = time.perf_counter()
        history, got = run(env)
        want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
                **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * PROFILE["scan_steps"])}
        if got != want:
            raise AssertionError(f"scan {scan}: flash launches {got}, want {want}")
        return history, time.perf_counter() - t0

    (per_step, per_step_s), (scanned, scanned_s) = scan_run(1), scan_run(PROFILE["scan"])
    keys = ("step", "loss", "grad_norm", "next_token_accuracy")
    a = [tuple(h[k] for k in keys) for h in per_step]
    b = [tuple(h[k] for k in keys) for h in scanned]

    def step_ms(history):  # steps 5-8, unprofiled, one host fetch at the end
        t = [h["step"] / h["steps_per_s"] for h in history]
        return (t[1] - t[0]) / (history[1]["step"] - history[0]["step"]) * 1e3

    log("profile: scan " + json.dumps({
        "per_step": a, "scanned": b, "identical": a == b,
        "per_step_wall_s": per_step_s, "scanned_wall_s": scanned_s,
        "per_step_ms": step_ms(per_step), "scanned_ms": step_ms(scanned)}))
    if [h[0] for h in a] != [4, 8] or a != b:
        raise AssertionError(f"scanned history {b} differs from per-step {a}")
    shutil.rmtree(prof_dir, ignore_errors=True)
    return launches


def phase_text(torch, gpt, fa, root):
    """The text flow (docstring phase 21): the port's corpus CLI trains the
    tokenizer and writes the shards; ``gpt:train`` at GPT-2-small width
    trains from them with the tokenizer's vocabulary into a gs:// location
    under a fake root, resumes once, and a greedy continuation decodes.
    Returns the launches."""
    import numpy as np

    from tfk8s_tpu_torch.data.tokenizer import BPETokenizer
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    work = os.path.join(root, "build", "chip_smoke_text")
    shutil.rmtree(work, ignore_errors=True)
    shards, tok_dir = os.path.join(work, "shards"), os.path.join(work, "tok")
    seq = int(TRAIN_ENV["TFK8S_SEQ_LEN"])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tfk8s_tpu_torch.data.corpus", "--input",
         *(os.path.join(root, f) for f in TEXT["files"]), "--out-dir", shards,
         "--seq-len", str(seq), "--vocab-size", str(TEXT["vocab"]),
         "--num-shards", str(TEXT["shards"]), "--tokenizer-dir", tok_dir],
        cwd=root, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"corpus CLI failed:\n{out.stderr[-4000:]}")
    log(f"text: {out.stdout.strip()} in {cli_s:.2f} s")
    tok = BPETokenizer.load(tok_dir)
    layers = gpt.base_config().num_layers
    fake_root = os.path.join(work, "gcs")
    uri = f"gs://{TEXT['bucket']}/{TEXT['key']}"
    env = dict(TRAIN_ENV, TFK8S_VOCAB_SIZE=str(tok.vocab_size),
               TFK8S_INPUT_FILES=os.path.join(shards, "part-*.rio"),
               TFK8S_CHECKPOINT_DIR=uri, TFK8S_TRAIN_STEPS=str(TEXT["first_steps"]))
    before = os.environ.get("TFK8S_GCS_FAKE_ROOT")
    os.environ["TFK8S_GCS_FAKE_ROOT"] = fake_root
    try:
        fa.reset_launches()
        first = gpt.train(env)
        resumed = gpt.train(dict(env, TFK8S_TRAIN_STEPS=str(TEXT["steps"]),
                                 TFK8S_GANG_RESTARTS="1"))
        torch.cuda.synchronize()
        train_launches = dict(fa.LAUNCHES)
        ckpt_dir = os.path.join(fake_root, TEXT["bucket"], *TEXT["key"].split("/"))
        if Checkpointer(uri).directory != ckpt_dir:
            raise AssertionError(f"{uri} resolved to {Checkpointer(uri).directory}")
        latest = Checkpointer(ckpt_dir).latest_step()
        # float32 (TF32 off), so that the continuation can be held to the
        # checkpoint's own full-forward argmax
        cfg = gpt.base_config(vocab_size=tok.vocab_size, dtype=torch.float32,
                              attention_impl=TRAIN_ENV["TFK8S_ATTENTION_IMPL"])
        model = gpt.GPTLM(cfg)
        model.load_state_dict(Checkpointer(ckpt_dir).restore(map_location="cpu")["model"])
    finally:
        if before is None:
            os.environ.pop("TFK8S_GCS_FAKE_ROOT", None)
        else:
            os.environ["TFK8S_GCS_FAKE_ROOT"] = before
    model = model.to(DEVICE).eval()
    prompt_ids = tok.encode(TEXT["prompt"])
    with torch.no_grad():
        out_ids = gpt.greedy_generate(cfg, model, torch.tensor([prompt_ids], device=DEVICE),
                                      TEXT["gen"])
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    tokens = out_ids[0].tolist()
    text = tok.decode(tokens)
    checked, ties = _greedy_check(torch, model, [np.asarray(prompt_ids, np.int64)], [tokens])
    losses = [h["loss"] for h in first + resumed]
    log("text: " + json.dumps({
        "vocab": tok.vocab_size, "cli_s": cli_s, "first_steps": [h["step"] for h in first],
        "resumed_steps": [h["step"] for h in resumed], "losses": losses,
        "checkpoint": os.path.relpath(ckpt_dir, root), "latest_step": latest,
        "continuation": text, "continuation_ids": tokens, "tokens_checked": checked,
        "near_ties": ties, "launches": launches}))
    if [h["step"] for h in resumed] != list(range(TEXT["first_steps"] + 1, TEXT["steps"] + 1)):
        raise AssertionError("the resumed run did not start after the first run's checkpoint")
    if latest != TEXT["steps"]:
        raise AssertionError(f"latest committed step {latest} under {ckpt_dir}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * TEXT["steps"])}
    if train_launches != want:
        raise AssertionError(f"flash launches {train_launches}, want {want}")
    if launches != dict(want, flash_fwd_simt=layers):
        raise AssertionError(f"the continuation's prefill: {launches}")  # one flash forward a layer
    if checked != TEXT["gen"]:
        raise AssertionError(f"{checked} of {TEXT['gen']} continuation tokens checked")
    if not text:
        raise AssertionError("the greedy continuation decoded to an empty string")
    shutil.rmtree(work, ignore_errors=True)
    return launches


# phase images: image-record input (TFK8S_INPUT_FORMAT=image). Eight 64x64
# class images, JPEG at quality 75 (made with PIL once and kept here: the
# card's host may have no PIL), repeated into IMAGES["shards"] shards of
# IMAGES["records"] records each, every record stamped with its true
# geometry (read from the JPEG's frame header here, by no decoder)
IMAGE_CLASS_JPEGS = (
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwDEpjVJiopDitcJXgqmpxYerHnImqOkkkxSxfPX2VLHUvY2ufRqadIStXT+1QxWm/tWjb2/lY4rxMZXjPRHh19ZHQad"
     "2rWrnbe58rHNWv7S/wBqvm62HnKV0crpSZyeKrTnGag+2+9IZfNrg9lXp+8zy6DnGV2U55MZq5p/z4pptPN7VfsrXysc"
     "VSzGpH3Wz6GljI8nKzf0+0344qzdW/lZ4qCyuvKxzS3d55mea7KGJlOWol70rmXdXPlZ5ql/aX+1T7tfMzVD7P7V9BRl"
     "RcdTsgoW1Oc+2+9athL5uKzv7P8AatfTrXZjit8dTw7pPk3PAqSpuNo7nQ2Fp5uOKtz2vk9qdpzbMVauj5ma/O8Rha3t"
     "7x2PPhSxHtL9DCnuvJ71Ct55nerN1Z+ZnioI7LZ2r0qVKpCN2e9Snyw97ckVfMp/2b2qSOPZU2abxU46EyrO+hk/2f8A"
     "7NWIbXZ2q7RXfQxM6k+WR8tl1aVSsoyHQtsq2h8yqNXbbtX0VLA0pQ5mj9QpYGk8Jz21LKWfmdqbLZbM8VpW3akuu9cW"
     "LoQjDQ+QxcnCryowJY9lQZq5dd6pV8fiXaZgpNn/2Q=="),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwDja1tO7Vheb71qWE+Mc17GKqxlTsjKeHmkdtp3atlK5ewu8Y5rYS896+Ix2HnOTsclL3Kl2a6Vz2ufxVppd+9YurS7"
     "91ePSy+sqvNY+nw+NpKFmzz3XP4q5uur1aLfurB+ye1fW4aLjCzNvrVNlrzavWk+Mc1N/Zf+zU0Wn7e1dMJTk7E15UXH"
     "Q0bS7xjmtSK896x47fb2qyo216FLBqWsj5jFwd7xNuK796rXku/NU1l20jy7q6p4OhGF+p4bqYiM/IzLyLfnis/7J7Vt"
     "Ou6ovKrxqsLSsjtp42aWrOj/ALL/ANmopNP2/wANdR5NUrmPGa2w8oOZ0Qxc27M5t7fb2qrINua1bnjNZ0i7q+njCPsr"
     "o9Gny1FqUZJdvehJd3epJLfd2pgi2dq8avUfNYuvgV7PmSLCLuqTyqqibZ3pftnvXK6bep8niYTjOyPUPJrOvY8ZrZrL"
     "v+9eNg6kvaG8JO5y97xmqKruq/f96pRdq+6pO9A9rBSbmkSrb7u1VLuLZmtWGqOod68SprUPrnSi8Pc527m2Z5qj9s96"
     "l1DvWVXVCCsfFYylH2h//9k="),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwBlKKi30hlxXPQacz7rNHzYdpFgVo2fasQ3GO9Tw3+zHNe7OhKVHQ/G8XQn9budpZ9qh1DvWHDrWzHzU99T8/8Air5f"
     "6lVWI5rHvUl+6sZmod6yq35IPP7ZqL+y/wDZr67Cvlp2Z51WhNyujM31FJLioPP96rTT+9fJYKp+9Vz9NxNZThYlkuMd"
     "6qS3+zvVWa496pSPvr9Cwk6MqVmfIYjBqVTmRbl1rZ/FWxpOp+ft+auRktvM7Vs6Qnkbe1FbDUbcyM40JI9P0mDz9vGa"
     "3f7L/wBmuP0jVvI2/Nit7/hIv9uvDq1FGVkdKp07anlXn+9Vp5+vNdD/AGN/s1VuNG6/LXxNGtaWh1/Wu5ys9x70tu+/"
     "Falxo/X5abBp/l44r6LB4uaNIVaUnYkt7bfjirDJ5FTQDy8VDdvuzX0CxanTt1OqpQi4XRC2reR/Fim/8JF/t/rWTdx7"
     "s1R8j2rzKtCrOV0eBWUlKyPoT+xv9mqlzo3X5a62qdz3r87w9RuZx1Kskjh7nR+vy1kXGn+Xniu3ue9c9qHevqaTtTuc"
     "+FxE3WscncDy81nSPurT1DvWQa1wdebr8rPvaK5sPdleWPdUPke1WjTa/S8Bhac6SbPGr01zn//Z"),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwD0iuU8Q/x1ufa/eud1qTzN1U8TBnu1naJ5Z4h/jrGse1dPrVp5m7isq2stmOKqlJSloeFOtFzsalh2rqdP7VzVsmzF"
     "b1lNtxXo4mhKWH0NlSlJXR2endq1a5myvduOa0f7R/2q/M8fl9Z1m0jN0JlT7X71Qu5PMzWZ9u96Y17nvXsUqGJcj2cX"
     "CXs9CC7tPMzxWebLZ2rQa6z3qFpd3evocFhqsWpTPj40qzxPkVCmypoZtvehl3ULD7V9XTrUHS5Jbn3GFoJUbyL8N7t7"
     "1P8A2j/tVnLFTvKrzauBoVJXsZTlRi7Mx/t3vR9tz3rF873pRP713U8LhkzqqShJWNr7VnvU8M27HNYAuPer1rcdOa6c"
     "XChCheO5w08NTdS5vwruxVpYfas61n6c1opNnvX53Vx1SOJtfQ9qpStQ90kWKneT7UJJmpN9fT4XGwdP3mfE4tV1U0PK"
     "vO96Xz/eq9IaUa87noqrIsfaPertrcdOayDV217UsTiJunY7MLJuZ0lrP05rUimzWFadq1Ye1fF4p/vLn1UYJ0dTUikz"
     "U2+qkPap65vrdSOiPCr4aDmf/9k="),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwDkKmio8r2p6riuj2kT5yhh5xndlmKqt53qdWxUUy+ZmuihWipH0tCouTlOevO9UlroJrHzM8VCNM/2a9/6xD2Q6tGT"
     "jcylp1aw03/Zpf7O9q8OtUTkeHVi1I2PKpjrirGaay7q+fTm9j6Ovg1CF0U2bFSwL5mKVoM9quWlvjHFaRjVj7x4NOvy"
     "V7MlgsfMxxVk6Z/s1etI8YqzK22tfr7iuVs+uhVoSoW6mOdN/wBmj+zv9mrktzt71D9s96n6zfU+exGHcp3iY2akRd1O"
     "8qrEEPTiuilR5ZXkfX4+EVRdgSDd2q7Bb4xxUkMPTirGNlejXnQ9jZbn5ni3JV/dJYI8VDdttzR9o2d6o3VzuzzXxOJh"
     "Wda8dj0MJLEX12M+7udueao/bPenXZ3ZqjsraCqJan01CpR5ff3Om8qrMEXTim1Zgr7LFwUKd0ehjpP2TLcEPTio7obM"
     "1cg7VVv+9fGPF1HiOTofBOKlitTCurjZnms9rnd3qa/71mrX09HDQnS5mfWxw0I4bmRK53VHsp606uKpSimfH4vFVIVL"
     "I//Z"),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwD02pUrI+3e9OGoY71jXi3A09hOOrN1K5bxH/HV8apj+KsbVbj7Ru5zXg+yl7UrnUdGeW+I/wCOsnTu1djqul/aN3y5"
     "zVG10Xy8fLXr8rVIarRehc03tWvVe1s/LxxV7y68CvJKZsot7Fz7d70x9Qx3rL8yopHr6uc4tWPSxFWhyaGk+qY/iqWC"
     "4+0Y5zXPyHNammNjFcnJHmufKYqtaWhvwaX9ox8uc0+TRPL/AIa0NMmxipr66xnmtK04ezsjho4r95ZnPSWfl9qh8ulv"
     "tQxnmsz+0v8Aar5fEU5ud0fU4etTcNSh5lNZ80baljg39q+h9jWW58v9cqPRlZjmtGwbGKdHYb+1TC38jtim72t1Iqyc"
     "onQWE2Mc1Bql1t3c1kDUfI71l6hq+/PzVzrD15S8jylGoql0V9U1DbnmsX+0v9qq2oXe/PNZXm12Qy+TWqPao1aijY9C"
     "21o2UO7HFUa1tO7V9fisJTjTujijubNlYb8cVR1i38jdxjFdHp3asbxJ/HXyqiniOU6Ianm+saj5G7npXNyavv8A4qu+"
     "JP465Na+xwuCpOndo6Y0Y7mpJd7+9RebVZafWrwtNGqgkf/Z"),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwDia2dM/hq1/Yv+xV+z0zy8fLX3FXEQ5T2K+JhONkbOmfw10lvWDZx+XitJLjZ3rwcViIS0R8ziqMm+Y6C37Via5/FT"
     "k1PZ/FWPquoeZu5rw1Tk6t0eUk3OxxWufxVzVdJqp8zdWJ5HtXv0INRPXpYOpKN0ez/2L/s1G+meX/DXUVnXhxmuCviZ"
     "8pxYXE1J1LM594/LqjcXGzPNXbyXGayJv3ma8B4iftdT6ueHTw/MVbjU9mfmrOm1DzO9XJrDzO1VjpmP4a9vC16Ntdz5"
     "KMeXFa7GbMfMzUHke1bH2HHaj7H7V7dOrT5dD9BwE8KqS5j2OsrUDjNS/bfes69uN+ea+dmm1Y/PsDH96jA1CXGarW/7"
     "zFTXq781FbDZivJxFCaV0ffWX1U1bex8zHFPm0zb/DS2t3sxzVs3Xmd68mFetCrY+Fxlo1boxZrHHaoPsntW8Y/MpPsn"
     "tX0mHxcuTUxWLxEdEVftvvUb3G/vVKnLXoximzbBr94Pdd9V2Hl1aWq1z3rWvQj7O59o2/qxA93s71dsrrzMc1h3Per+"
     "l/w18jiKcVU0Ph8S71zsLKPzMVpfZPaqel/w1tU4zaR106UXE//Z"),
    ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwc"
     "KDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
     "MjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCABAAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
     "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
     "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
     "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
     "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
     "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
     "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
     "PwDi6tW/aq2KswV+hV8VT5DigrO7NS37VT1HvVuA9KqX/Oa+ar4mHOd0a0eWxyeo96n0j+Go79M5qfS1xtrnlXi0VRi+"
     "fmO40n+Gt6ue0tsba2/Mrnlqz6bD4qnGFmcFip4qv/2f7UfZNnasauYtxsmfESrQkrRCE1WvOc1axsqCVd+a8OpipuVy"
     "aWHrynfoc5eJnNS6euMVoy2O/tViz07GPlrSni3fU95U+Sld7mjp7YxWr5lQWlnjHFX/ALL7V6UMXTtqeFXx0oSsmT/2"
     "f7VSubTZnij+2v8AaqvNqXm5+avnl7XqeHlqrOuubYzrldmajhXfUsx83NS2sWMVpKL5T9YwlHDxw3NLcmhst/atKDTs"
     "Y4p1quMVqwjpXnVfaJ6HiZhiKVnGJHBZ4xxVn7L7VZhHSp9tcrxNVOx8TiaNWc7xPCf7a/2qvWupebj5q5CtjTf4a+0n"
     "Qike/Rw8Iyujs7U+bitaCLGKx9M/hrfirinFXserXxE4ULItQritGEdKoxVfg7Vz1qUeW58U8XUnieVmhCvSrG2oYO1W"
     "K8CtFKR9ng8LTnTTZ//Z"),
)
IMAGES = dict(shards=2, records=512, refuse_limit_s=30.0)
# with a decoder: ResNet-50 (configs[1]: batch 256, 224 px, 1000 classes)
# 4 steps, ViT-B/16 (batch 64) 2 steps, from the shards
IMAGES_RESNET_ENV = dict(RESNET_ENV, TFK8S_TRAIN_STEPS="4", TFK8S_DECODE_WORKERS="8")
IMAGES_VIT_ENV = {**FAMILY_ENV, **FAMILIES["vit"]["env"], "TFK8S_TRAIN_STEPS": "2",
                  "TFK8S_DECODE_WORKERS": "8"}


def _jpeg_geometry(raw):
    """(height, width, components) from a baseline or progressive JPEG's
    frame header (SOF0-SOF2), read without a decoder."""
    i = 2
    while i + 9 < len(raw):
        if raw[i] != 0xFF:
            raise ValueError(f"no JPEG marker at byte {i}")
        marker, size = raw[i + 1], int.from_bytes(raw[i + 2:i + 4], "big")
        if marker in (0xC0, 0xC1, 0xC2):
            return (int.from_bytes(raw[i + 5:i + 7], "big"),
                    int.from_bytes(raw[i + 7:i + 9], "big"), raw[i + 9])
        i += 2 + size
    raise ValueError("no JPEG frame header")


class _Records(logging.Handler):
    """Keeps the records of the loggers it is added to."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _image_decoders(held):
    """What decodes images on this host: PIL, the port's native core (and
    the compiler's last line when its build failed), and the backend
    ``resolve_backend(None)`` picks. ``held`` keeps the decode loggers'
    records."""
    from tfk8s_tpu_torch.data.images import _native_decode, decode

    core = _native_decode.load() is not None
    why = None
    if not core:
        failed = [r.getMessage() for r in held.records if "build" in r.getMessage()]
        lines = [ln for ln in (failed[-1] if failed else "").splitlines() if ln.strip()]
        why = lines[-1] if lines else "no g++ (nothing was compiled)"
    return {"pil": decode.have_decoder(), "native_core": core, "native_core_build": why,
            "backend": decode.resolve_backend(None)}


def _image_shards(work):
    """IMAGES' shards through the port's ``write_image_shards``: record i is
    class i % 8's JPEG with that label and its frame header's geometry."""
    import base64

    from tfk8s_tpu_torch.data.images import schema

    raws = [base64.b64decode(b) for b in IMAGE_CLASS_JPEGS]
    shapes = [_jpeg_geometry(r) for r in raws]
    n = IMAGES["shards"] * IMAGES["records"]
    recs = (schema.encode_image_example(raws[i % len(raws)], i % len(raws),
                                        shape=shapes[i % len(raws)]) for i in range(n))
    return schema.write_image_shards(recs, work, IMAGES["shards"]), shapes


def _image_train(torch, module, env, kernels):
    """``module.train(env)`` from the image shards: the summary of its
    history, progress and decode metrics (the pool's batches and their
    seconds), and the launches of ``kernels`` (a kernel module's
    ``LAUNCHES``, zeroed just before)."""
    from tfk8s_tpu_torch.data.images import pipeline
    from tfk8s_tpu_torch.runtime import progress
    from tfk8s_tpu_torch.utils.logging import Metrics

    steps = int(env["TFK8S_TRAIN_STEPS"])
    torch.cuda.empty_cache()
    progress.clear()
    reports, report = [], progress.report

    def keep(**values):  # every window's report, not only the last
        reports.append(values)
        report(**values)

    progress.report = keep
    reg = Metrics()
    pipeline.set_metrics(reg)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        history = module.train(env)
    finally:
        progress.report = report
        pipeline.set_metrics(None)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    prog = progress.snapshot()
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{module.__name__}: losses {losses}")
    metrics = reg.snapshot()
    decode = [h for k, h in metrics["histograms"].items()
              if k.startswith("tfk8s_image_decode_seconds")]
    decoded = sum(v for k, v in metrics["counters"].items()
                  if k.startswith("tfk8s_images_decoded_total"))
    decode_s = sum(h["sum"] for h in decode)
    return {"wall_s": time.perf_counter() - t0, "losses": losses,
            "decoded": metrics["counters"], "decode_batches": sum(h["count"] for h in decode),
            "decode_s": decode_s, "pool_images_per_s": decoded / decode_s if decode_s else None,
            "step_ms": [r["step_seconds"] * 1e3 for r in reports if "step_seconds" in r],
            "decoded_images_per_sec": [r["decoded_images_per_sec"] for r in reports
                                       if "decoded_images_per_sec" in r],
            "input_mb_per_sec": [r["input_mb_per_sec"] for r in reports
                                 if "input_mb_per_sec" in r],
            "input_wait_seconds": prog.get("input_wait_seconds"),
            "input_starved_steps": prog.get("input_starved_steps"),
            "launches": launches}


def phase_images(torch, fa, gn, root):
    """Image-record input (docstring phase 22). Returns the launches of the
    paths it drives: none where the host has no decoder."""
    from tfk8s_tpu_torch.data.images import ImageDecodeError
    from tfk8s_tpu_torch.models import resnet, vit

    t0 = time.perf_counter()
    held = _Records()
    loggers = [logging.getLogger(n) for n in ("tfk8s.data.native", "tfk8s.data.images.native")]
    for lg in loggers:
        lg.addHandler(held)
    work = os.path.join(root, "build", "chip_smoke_images")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        card = phase_card()
        decoders = _image_decoders(held)
        log(f"images host decoders: {json.dumps(decoders)}")
        paths, shapes = _image_shards(work)
        files = os.path.join(work, "images-*.rio")
        log(f"images shards: {json.dumps({'paths': paths, 'records': IMAGES['records'], 'geometry': sorted(set(shapes)), 'bytes': sum(os.path.getsize(p) for p in paths)})}")
        dev = {"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {}
        image_env = dict(dev, TFK8S_INPUT_FILES=files, TFK8S_INPUT_FORMAT="image")
        total = {**dict.fromkeys(fa.KERNELS, 0), **dict.fromkeys(gn.KERNELS, 0)}
        if not (decoders["pil"] or decoders["native_core"]):
            # no decoder: the typed refusal before the first step, and the
            # same shards as array records refused by their schema
            gn.reset_launches()
            try:
                resnet.train(dict(IMAGES_RESNET_ENV, **image_env))
            except ImageDecodeError as exc:
                refusal = str(exc)
            else:
                raise AssertionError("resnet:train trained from image shards with no decoder")
            launches = dict(gn.LAUNCHES)
            try:
                resnet.train(dict(IMAGES_RESNET_ENV, **dev, TFK8S_INPUT_FILES=files))
            except ValueError as exc:
                as_array = str(exc)
            else:
                raise AssertionError("image shards trained as array records")
            refuse_s = time.perf_counter() - t0
            log(f"images refusal (no decoder on this host): {json.dumps({'card': card, 'refusal': refusal, 'group_norm_launches': launches, 'as_array_records': as_array, 'seconds': refuse_s})}")
            if "Pillow" not in refusal:
                raise AssertionError(f"the refusal does not name Pillow: {refusal}")
            if any(launches.values()):
                raise AssertionError(f"GroupNorm launched before the refusal: {launches}")
            if not re.search("input_format|schema", as_array):
                raise AssertionError(f"array-format refusal: {as_array}")
            if refuse_s > IMAGES["refuse_limit_s"]:
                raise AssertionError(f"the refusal took {refuse_s:.1f} s, past "
                                     f"{IMAGES['refuse_limit_s']} s")
        else:
            rn = _image_train(torch, resnet, dict(IMAGES_RESNET_ENV, **image_env), gn)
            steps = int(IMAGES_RESNET_ENV["TFK8S_TRAIN_STEPS"])
            want = {**dict.fromkeys(gn.TWO_READ_KERNELS, 0),
                    **dict.fromkeys(gn.ONE_READ_KERNELS, RESNET_GN_SITES * steps)}
            log(f"images resnet train: {json.dumps({'card': card, **rn})}")
            if rn["launches"] != want:
                raise AssertionError(f"resnet: GroupNorm launches {rn['launches']}, want {want}")
            vt = _image_train(torch, vit, dict(IMAGES_VIT_ENV, **image_env), fa)
            steps = int(IMAGES_VIT_ENV["TFK8S_TRAIN_STEPS"])
            want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
                    **dict.fromkeys(fa.TENSOR_CORE_KERNELS, FAMILIES["vit"]["sites"] * steps)}
            log(f"images vit train: {json.dumps({'card': card, **vt})}")
            if vt["launches"] != want:
                raise AssertionError(f"vit: flash launches {vt['launches']}, want {want}")
            for launches in (rn["launches"], vt["launches"]):
                for k, v in launches.items():
                    total[k] += v
        fallback = [r.getMessage() for r in held.records
                    if "native core unavailable" in r.getMessage()]
        log(f"images fallback warnings: {json.dumps(fallback)}")
        if len(fallback) != (0 if decoders["native_core"] else 1):
            raise AssertionError(f"{len(fallback)} fallback warnings: {fallback}")
        return total
    finally:
        for lg in loggers:
            lg.removeHandler(held)
        shutil.rmtree(work, ignore_errors=True)


# phase pod_ranks: a pod whose mesh spans more devices than the job has
# processes runs one rank process a device, started by the entry point
POD = dict(seed=31, gang_steps=3, fault_limit_s=60.0)
POD_GPT = {"TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8"}
POD_T5 = {"TFK8S_SEQ_LEN": "512", "TFK8S_BATCH_SIZE": "8"}
# over NCCL, a card a rank, at full depth: (name, mesh, cards it needs)
POD_NCCL_JOBS = [
    ("gpt_ddp", {"data": 2}, 2),
    ("gpt_fsdp2", {"fsdp": 2}, 2),
    ("gpt_hsdp", {"data": 2, "fsdp": 2}, 4),
    ("gpt_fsdp4", {"fsdp": 4}, 4),
]


def pod_entry(env, stop=None):
    """A family's ``train(env, stop)`` (``FAMILY``) at ``GANG_LAYERS``
    depth, with the families' first act: where the pod runs several ranks
    it starts them on this function (``pod_ranks.ranks``) and returns rank
    0's history. The depth cut patches the presets, so it must happen in
    each rank, hence this entry point beside the families'. In a rank:
    ``POD_GRADS``, rank 0 saves the first update's whole gradient there;
    ``POD_FAULT_RANK``, that local rank raises at its first step."""
    import importlib

    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from tfk8s_tpu_torch.runtime import pod_ranks
    from tfk8s_tpu_torch.runtime import train as ttrain

    history = pod_ranks.ranks("chip_smoke:pod_entry", env, stop)
    if history is not None:
        return history
    if "POD_FAULT_RANK" in env and env["POD_FAULT_RANK"] == env.get("TFK8S_LOCAL_RANK"):
        def planted(self, state, batch):
            raise RuntimeError(f"planted failure at step {state.step + 1}")

        ttrain.Trainer.train_step = planted
    held, init_state = [], ttrain.Trainer.init_state

    def holding(self):
        state = init_state(self)
        held.append((self.parallel, state.model))
        return state

    def hook(opt, args, kwargs):
        if env.get("POD_GRADS") and len(held) == 1:
            parallel, model = held.pop()
            grads = [g.float().cpu() for g in parallel.whole_grads(model).values()]
            if env["TFK8S_PROCESS_ID"] == "0":
                torch.save(grads, env["POD_GRADS"])

    ttrain.Trainer.init_state = holding
    handle = register_optimizer_step_pre_hook(hook)
    module = importlib.import_module("tfk8s_tpu_torch.models." + env["FAMILY"])
    try:
        with gang_depth(env.get("GANG_LAYERS")):
            return module.train(env, stop)
    finally:
        handle.remove()
        ttrain.Trainer.init_state = init_state


def _pod_env(family, extra, mesh, steps, layers=GANG_LAYERS):
    tiny = PARALLEL_ENV.get("TFK8S_MODEL_PRESET") == "tiny"
    env = dict({"TFK8S_MODEL_PRESET": "tiny"} if tiny else {},
               **({"TFK8S_DEVICE": "cpu"} if DEVICE == "cpu" else {}),
               **({"GANG_LAYERS": str(layers)} if layers else {}),
               **extra, FAMILY=family, TFK8S_TRAIN_STEPS=str(steps), TFK8S_LOG_EVERY="1",
               TFK8S_LEARNING_RATE="1e-4", TFK8S_SEED=str(POD["seed"]),
               TFK8S_ATTENTION_IMPL="flash")
    if mesh is not None:
        env["TFK8S_MESH"] = json.dumps(mesh)
    return env


def _pod_run(torch, env, grads=None):
    """``pod_entry(env)`` as a pod's process runs it (the pod env, no
    mesh-sized process count): (history, PodRun, rank 0's whole first
    gradient or None, the wall seconds)."""
    from tfk8s_tpu_torch.runtime import pod_ranks

    full = dict(env, **({"POD_GRADS": grads} if grads else {}))
    t0 = time.perf_counter()
    history = pod_entry(full)
    wall = time.perf_counter() - t0
    run = pod_ranks.last_run()
    got = torch.load(grads) if grads else None
    if grads:
        os.remove(grads)
    return history, run, got, wall


def _pod_summary(history, run, wall):
    """What a spawned pod's run cost: wall time, spawn to rank 0's first
    finished step, the step time (the history's clock from the first
    logged step to the last), each rank's wall and peak memory."""
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    steps = history[-1]["step"] - history[0]["step"]
    return {"wall_s": wall, "spawn_to_first_step_s": run.first_step_s,
            "step_ms": (t_last - t_first) / steps * 1e3 if steps else None,
            "ranks": [{"rank": run.first_rank + l, "wall_s": r["wall_s"],
                       "peak_gib": (r["peak_memory_bytes"] or 0) / 2**30}
                      for l, r in enumerate(run.records)]}


def _pod_placement(run, backend):
    """Every rank over ``backend``; over NCCL each on a card of its own."""
    got = [(r["backend"], r["device"]) for r in run.records]
    if {b for b, _ in got} != {backend}:
        raise AssertionError(f"ranks' backends and devices {got}, want {backend}")
    if backend == "nccl" and len({d for _, d in got}) != len(got):
        raise AssertionError(f"NCCL ranks share a card: {got}")


def _pod_launches(fa, run, want):
    """Each rank's flash launches, which must be ``want``; their sum."""
    total = dict.fromkeys(fa.KERNELS, 0)
    for l, r in enumerate(run.records):
        got = r["launches"].get("flash_attention", {})
        if got != want:
            raise AssertionError(f"rank {run.first_rank + l} flash launches {got}, want {want}")
        for k, v in got.items():
            total[k] += v
    return total


def _flash(fa, sites, layers, steps):
    return {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, sites * layers * steps)}


def _pod_against_one(torch, fa, name, family, extra, mesh, steps, sites, card, work,
                     backend, layers=GANG_LAYERS):
    """A pod of ``family`` on ``mesh``, started by the entry point, against
    one process of the same job: the first loss within PARALLEL_LOSS_ATOL
    and the first update's whole gradient within FAMILY_GRAD_REL_L2; every
    rank over ``backend`` (on NCCL, a card of its own) and its flash
    launches sites x layers x steps. Returns the launches."""
    import importlib

    module = importlib.import_module(f"tfk8s_tpu_torch.models.{family}")
    env = _pod_env(family, extra, None, steps, layers)
    losses, want, one_ms, got, fresh = one_process(torch, fa, module, env)
    n_layers = family_layers(module, env)
    if got != _flash(fa, sites, n_layers, steps):
        raise AssertionError(f"{name} one process: flash launches {got}")
    torch.cuda.empty_cache()
    history, run, grads, wall = _pod_run(torch, _pod_env(family, extra, mesh, steps, layers),
                                         os.path.join(work, f"{name}.pt"))
    errs = {"loss_err": abs(history[0]["loss"] - losses[0]),
            "grad_rel_l2": _grads_rel_l2(dict(enumerate(grads)), dict(enumerate(want))),
            "finite": all(math.isfinite(h["loss"]) for h in history)}
    total = _pod_launches(fa, run, _flash(fa, sites, n_layers, steps))
    _pod_placement(run, backend)
    log(f"pod_ranks {name} {json.dumps(mesh)}: {json.dumps({'card': card, **errs, 'one_process_loss': losses[0], 'one_process_step_ms': one_ms, 'losses': [h['loss'] for h in history], **_pod_summary(history, run, wall)})}")
    if not (errs["finite"] and errs["loss_err"] <= PARALLEL_LOSS_ATOL
            and errs["grad_rel_l2"] <= FAMILY_GRAD_REL_L2):
        raise AssertionError(f"{name}: {errs} (bounds: loss {PARALLEL_LOSS_ATOL}, relative L2 "
                             f"{FAMILY_GRAD_REL_L2})")
    if fresh:
        for k, v in got.items():
            total[k] += v
    return total


def phase_pod_ranks(torch, fa, root):
    """One pod of GPT-2-small on ``{"data": 2}`` started by the entry point
    (two gloo ranks sharing the card) against two processes started by
    hand, bit for bit; a pod of T5-base on ``{"data": 2, "tensor": 2}``
    against one process; a planted failing rank (docstring phase 23).
    Returns the launches of the paths it drives."""
    import importlib

    from tfk8s_tpu_torch.runtime import pod_ranks

    card = phase_card()
    work = os.path.join(root, "build", "chip_smoke_pod")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    total = dict.fromkeys(fa.KERNELS, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # (a) the spawned pair against the hand-started pair: the same ranks
    # on the same input (per_host, a shard a rank, on both)
    def backend(ranks):  # NCCL where each rank has a card of its own
        return "gloo" if DEVICE == "cpu" or torch.cuda.device_count() < ranks else "nccl"

    steps = POD["gang_steps"]
    extra = dict(POD_GPT, TFK8S_INPUT_MODE="per_host", TFK8S_INPUT_SHARDS="2")
    env = _pod_env("gpt", extra, {"data": 2}, steps)
    torch.cuda.empty_cache()
    history, run, grads, wall = _pod_run(torch, env, os.path.join(work, "gpt_data.pt"))
    layers = family_layers(importlib.import_module("tfk8s_tpu_torch.models.gpt"), env)
    add(_pod_launches(fa, run, _flash(fa, 1, layers, steps)))
    _pod_placement(run, backend(2))
    gang = _run_par_gangs(2, [dict(name="gpt_data_hand", out=os.path.join(work, "gpt_data_hand"),
                                   want=grads, env=dict(env, WHOLE_GRADS="1"))])
    records, hand_grads = gang["gpt_data_hand"]
    same_losses = [h["loss"] for h in history] == records[0]["losses"] == records[1]["losses"]
    same_grads = all(torch.equal(a, b) for a, b in zip(grads, hand_grads))
    grads_diff = max(float((a - b).abs().max()) for a, b in zip(grads, hand_grads))
    log(f"pod_ranks gpt_data {{\"data\": 2}}: {json.dumps({'card': card, 'backend': 'gloo', 'losses': [h['loss'] for h in history], 'hand_started_losses': records[0]['losses'], 'identical_losses': same_losses, 'identical_grads': same_grads, 'grads_max_abs_diff': grads_diff, 'hand_started_step_ms': records[0]['step_ms'], 'hand_started_peak_gib': [r['peak_gib'] for r in records], **_pod_summary(history, run, wall)})}")
    if not (same_losses and same_grads):
        raise AssertionError("the spawned pod's run differs from the hand-started ranks'")

    # (b) T5-base on the reference's {"data": 2, "tensor": 2}, a pod of four
    add(_pod_against_one(torch, fa, "t5_data_tensor", "t5", POD_T5, {"data": 2, "tensor": 2},
                         steps, 3, card, work, backend(4)))

    # (c) a rank that fails: the pod raises naming it, and no rank outlives it
    env = _pod_env("gpt", POD_GPT, {"data": 2}, steps)
    t0 = time.perf_counter()
    try:
        pod_entry(dict(env, POD_FAULT_RANK="1"))
    except pod_ranks.RankFailed as e:
        failed = e
    else:
        raise AssertionError("the pod with a failing rank returned")
    fail_s = time.perf_counter() - t0
    run = pod_ranks.last_run()
    alive = [pid for pid in run.pids if _alive(pid)]
    log(f"pod_ranks failing rank: {json.dumps({'card': card, 'error': str(failed)[:300], 'rank': failed.rank, 'raised_after_s': fail_s, 'alive': alive})}")
    if (failed.rank, failed.local_rank) != (1, 1) or "planted failure at step 1" not in str(failed):
        raise AssertionError(f"the failing pod raised {failed!r}")
    if fail_s > POD["fault_limit_s"] or alive:
        raise AssertionError(f"failing pod: raised after {fail_s:.1f} s, ranks alive {alive}")
    shutil.rmtree(work, ignore_errors=True)
    return total


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _pod_nccl(torch, fa, root, cards):
    """POD_NCCL_JOBS that fit ``cards``: GPT-2-small at full depth, a pod
    of a card a rank started by the entry point (NCCL), against one
    process. Returns the launches."""
    work = os.path.join(root, "build", "chip_smoke_pod_nccl")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    card = phase_card()
    total = dict.fromkeys(fa.KERNELS, 0)
    for name, mesh, need in POD_NCCL_JOBS:
        if need > cards:
            log(f"nccl: pod {name} {json.dumps(mesh)} skipped: {cards} cards, it needs {need}")
            continue
        got = _pod_against_one(torch, fa, name, "gpt", POD_GPT, mesh, POD["gang_steps"], 1,
                               card, work, "nccl", layers=None)
        for k, v in got.items():
            total[k] += v
    shutil.rmtree(work, ignore_errors=True)
    return total


# phase operator: the port's own control plane on the card. (a) is the
# example manifest's GPT-2-small job; (b), a second h100-1 job at
# GANG_LAYERS depth, is submitted while (a) runs and must wait for its host
OPERATOR = dict(manifest=os.path.join("manifests", "examples", "gpt-h100-torch.json"),
                gang_steps=3, timeout_s=300.0, limit_s=90.0, loss_atol=2e-2,
                apiserver_start_s=60.0, lease_s=8.0, failover_limit_s=8.0, hold_s=60.0,
                low_steps=12, high_steps=4, preempt_at=4, suspend_after=2, ckpt_every=2,
                lost_steps=6, lost_hold_at=5, node_lease_s=2.0, node_renew_s=0.5)
# job (b)'s entry point, a name the phase registers for pod_entry
OPERATOR_GANG_ENTRY = "chip_smoke.operator_gang"
# jobs (c) and (d): (c) at priority 1 is preempted by (d) at priority 10,
# then suspended and resumed; both pod_entry at GANG_LAYERS depth
OPERATOR_LOW = ("gpt-h100-low", "chip_smoke.operator_low", 1)
OPERATOR_HIGH = ("gpt-h100-high", "chip_smoke.operator_high", 10)
# job (e): its pod runs in the kubelet processes node-a, then node-b, which
# resolve the entry point by module:attr
OPERATOR_LOST = ("gpt-h100-lost", "chip_smoke:node_loss_entry")


def _write_json(path, record):
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)


def _listing(directory):
    """Every path under ``directory`` with its size and modification time
    in nanoseconds."""
    out = {}
    for top, dirs, files in os.walk(directory):
        for name in dirs + files:
            path = os.path.join(top, name)
            try:
                st = os.lstat(path)
            except FileNotFoundError:
                continue
            out[os.path.relpath(path, directory)] = [st.st_size, st.st_mtime_ns]
    return out


def node_loss_entry(env, stop=None):
    """Job (e)'s entry point in a ``kubelet`` verb process: ``pod_entry``,
    recorded into the directory ``env["NODE_LOSS_RECORDS"]``. At its start
    it writes ``start-<TFK8S_GANG_RESTARTS>.json``: the wall time, the
    checkpoint directory's listing and the committed step it finds. In the
    first run, after update
    ``NODE_LOSS_HOLD_AT`` it writes ``held.json`` and waits for its stop
    (its node is killed meanwhile). A run that ends writes
    ``run-<TFK8S_GANG_RESTARTS>.json``: its history, the wall times at
    which its model and optimizer were built and its first update ended,
    its flash launches and its peak memory."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from tfk8s_tpu_torch.ops import flash_attention as fa
    from tfk8s_tpu_torch.runtime import train as ttrain
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    records, run = env["NODE_LOSS_RECORDS"], env.get("TFK8S_GANG_RESTARTS", "0")
    ckpt_dir = env["TFK8S_CHECKPOINT_DIR"]
    card = env.get("TFK8S_DEVICE") != "cpu"
    start = {"entered": time.time(), "env": dict(env), "listing": _listing(ckpt_dir)}
    ckpt = Checkpointer(ckpt_dir)
    start["ckpt_step"] = ckpt.latest_step()
    ckpt.close()
    _write_json(os.path.join(records, f"start-{run}.json"), start)
    rec = {"updates": 0}

    def hook(opt, args, kwargs):
        # torch's state-dict loader steps a resumed optimizer once at lr 0
        if all(float(g.get("lr", 1.0)) == 0.0 for g in opt.param_groups):
            return
        rec["updates"] += 1
        if rec["updates"] == 1:
            if card:
                torch.cuda.synchronize()
            rec["first_update"] = time.time()
        if run == "0" and rec["updates"] == int(env["NODE_LOSS_HOLD_AT"]):
            _write_json(os.path.join(records, "held.json"), {"at": time.time()})
            stop.wait(OPERATOR["hold_s"])

    init_state = ttrain.Trainer.init_state

    def timed(self):  # the model and optimizer on the card, before the restore
        state = init_state(self)
        rec.setdefault("state_built", time.time())
        return state

    ttrain.Trainer.init_state = timed
    handle = register_optimizer_step_post_hook(hook)
    before = dict(fa.LAUNCHES)
    if card:
        torch.cuda.reset_peak_memory_stats()
    try:
        history = pod_entry(env, stop)
    finally:
        handle.remove()
        ttrain.Trainer.init_state = init_state
    if card:
        torch.cuda.synchronize()
    rec.update(history=history, end=time.time(),
               launches={k: fa.LAUNCHES[k] - before[k] for k in fa.KERNELS},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card else None)
    _write_json(os.path.join(records, f"run-{run}.json"), rec)
    return history


def _operator_server(capacity, kubeconfig="", **opts):
    """The port's operator in this process: store (with ``kubeconfig``, a
    ``RemoteStore`` to that apiserver), clientset, gang allocator over
    ``capacity``, TPUJob controller and local kubelet, started, with
    ``opts`` further ``Options`` (a lease, no local kubelet); (server, its
    stop event)."""

    from tfk8s_tpu_torch.cmd.options import Options
    from tfk8s_tpu_torch.cmd.server import Server

    server = Server(Options(capacity=capacity, workers=2, kubeconfig=kubeconfig, **opts))
    stop = threading.Event()
    server.run(stop, block=False)
    return server, stop


class _APIServerProcess:
    """``python -m tfk8s_tpu_torch.cmd.main apiserver`` in its own process
    on a free port, journaled to ``work/journal``; with ``tls``, HTTPS from
    a self-signed CA and one read-write bearer token. The first ``start``
    writes ``work/kc.json``; a later one starts it again on the same port,
    from the same journal and with the same certificates."""

    def __init__(self, root, work, tls):
        import socket

        self.root, self.work, self.tls = root, work, tls
        self.kubeconfig = os.path.join(work, "kc.json")
        self.journal = os.path.join(work, "journal")
        self.pki = os.path.join(work, "pki")
        self.tokens = os.path.join(work, "tokens")
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        self.port = sock.getsockname()[1]
        sock.close()
        self.proc, self.starts = None, 0
        if tls:
            import secrets

            with open(self.tokens, "w") as f:
                f.write(f"{secrets.token_hex(16)},chip-smoke\n")

    def _args(self):
        args = ["apiserver", "--port", str(self.port), "--journal-dir", self.journal]
        if self.starts == 0:
            args += ["--write-kubeconfig", self.kubeconfig]
            if self.tls:
                args += ["--self-signed", self.pki, "--token-file", self.tokens]
        elif self.tls:  # the first start's CA and certificate
            args += ["--tls-cert", os.path.join(self.pki, "apiserver.crt"),
                     "--tls-key", os.path.join(self.pki, "apiserver.key"),
                     "--client-ca", os.path.join(self.pki, "ca.crt"),
                     "--token-file", self.tokens]
        return args

    def start(self):
        """Start it and wait for ``/healthz``; the seconds that took."""
        from tfk8s_tpu_torch.client.remote import load_kubeconfig, store_from_kubeconfig

        t0, self.t_wall = time.perf_counter(), time.time()
        self.log_path = os.path.join(self.work, f"apiserver-{self.starts}.log")
        with open(self.log_path, "wb") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m", "tfk8s_tpu_torch.cmd.main"]
                + self._args(),
                cwd=self.root, env=dict(os.environ, PYTHONPATH=self.root),
                stdout=out, stderr=subprocess.STDOUT)
        self.starts += 1
        deadline = time.monotonic() + OPERATOR["apiserver_start_s"]
        while time.monotonic() < deadline and self.proc.poll() is None:
            if os.path.exists(self.kubeconfig) and os.path.getsize(self.kubeconfig):
                if store_from_kubeconfig(load_kubeconfig(self.kubeconfig)).healthz():
                    return time.perf_counter() - t0
            time.sleep(0.05)
        raise AssertionError(f"the apiserver did not answer /healthz (rc {self.proc.poll()}):\n"
                             + self.tail())

    def listening_s(self):
        """Seconds from the last start to the process's own "listening"
        log line: its imports, the journal's replay and the bind."""
        import datetime

        with open(self.log_path, errors="replace") as f:
            for line in f:
                if "apiserver listening on" in line:
                    stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
                    return stamp.timestamp() - self.t_wall
        return None

    def imports(self):
        """Seconds the last start spent importing (``-X importtime``'s
        top-level modules) and, of those, in torch."""
        total = torch_s = 0.0
        with open(self.log_path, errors="replace") as f:
            for line in f:
                if not line.startswith("import time:") or "cumulative" in line:
                    continue
                _self, cum, name = line[len("import time:"):].split("|")
                if not name[1:].startswith(" "):  # a top-level import
                    total += int(cum) / 1e6
                if name.strip() == "torch":  # at whatever depth it came first
                    torch_s = int(cum) / 1e6
        return {"total_s": round(total, 3), "torch_s": round(torch_s, 3)}

    def kill(self):
        """SIGKILL, as a crash would end it."""
        import signal

        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)

    def tail(self):
        with open(self.log_path, errors="replace") as f:
            return f.read()[-3000:]


def _job_state(server, name, recorders=None):
    """(condition types, event reasons, pods) of a job on ``server``; the
    reasons those of ``recorders`` (default: the server's)."""
    from tfk8s_tpu_torch.trainer import labels as L

    status = server.clientset.tpujobs().get(name).status
    pods, _ = server.clientset.pods().list(label_selector={L.JOB_NAME: name})
    reasons = [e.reason for r in (recorders or [server.recorder])
               for e in r.events(key=f"default/{name}")]
    return [c.type.value for c in status.conditions if c.status], reasons, pods


def _wait_jobs(server, names, timeout_s, each=None, recorders=None):
    """Poll until every job of ``names`` has ended (``each()`` once a
    poll); their final states."""
    deadline = time.monotonic() + timeout_s
    while True:
        # the last job first: a later job's pod seen beside an earlier job
        # that has not ended is then no artefact of the two reads' order
        states = {n: _job_state(server, n, recorders) for n in reversed(names)}
        if each is not None:
            each(states)
        if all({"Succeeded", "Failed"} & set(st[0]) for st in states.values()):
            return states
        if time.monotonic() > deadline:
            raise AssertionError(f"jobs {names} did not end within {timeout_s:.0f} s: "
                                 f"{ {n: st[:2] for n, st in states.items()} }")
        time.sleep(0.05)


# the record of the _recorded run on this thread, which _update_hook reads
_RUN = threading.local()


def _recorded(torch, fa, runs, name, fn, extra=None):
    """An entry point that runs ``fn(env, stop)`` and appends to
    ``runs[name]`` one record per run: its index, env, stop signal, entry
    into the wrapper, start and end, history, finished updates, peak device memory and the flash
    launches made in the process while it ran (its own while no other
    job's pod runs on the card). ``extra(rec)``, called before the start,
    adds fields: ``hold_at`` and ``hold`` make ``_update_hook`` wait on the
    event ``hold`` after that many updates."""

    def run(env, stop):
        entered = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"index": len(runs[name]), "thread": threading.get_ident(), "env": dict(env),
               "stop": stop, "updates": 0, "entered": entered}
        if extra is not None:
            extra(rec)
        rec["start"] = time.perf_counter()
        before = dict(fa.LAUNCHES)
        runs[name].append(rec)
        _RUN.rec = rec
        try:
            rec["history"] = fn(env, stop)
        finally:
            _RUN.rec = None
            torch.cuda.synchronize()
            rec["end"] = time.perf_counter()
            rec["launches"] = {k: fa.LAUNCHES[k] - before[k] for k in fa.KERNELS}
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return rec["history"]

    return run


def _update_hook(torch):
    """An optimizer post-step hook for ``_recorded`` runs: it counts the
    run's finished updates, stamps the first, and at update ``hold_at``
    waits on the run's ``hold`` event (``OPERATOR["hold_s"]`` at most). The
    step torch's state-dict loader takes at lr 0 to build a resumed run's
    optimizer state is no update."""

    def hook(opt, args, kwargs):
        rec = getattr(_RUN, "rec", None)
        if rec is None or all(float(g.get("lr", 1.0)) == 0.0 for g in opt.param_groups):
            return
        rec["updates"] += 1
        if rec["updates"] == 1:
            torch.cuda.synchronize()
            rec["first_step"] = time.perf_counter()
        if rec["updates"] == rec.get("hold_at"):
            rec["held"] = time.perf_counter()
            rec["hold_seen"] = rec["hold"].wait(OPERATOR["hold_s"])
            rec["stopped"] = time.perf_counter()

    return hook


def _verb(argv):
    """``tfk8s_tpu_torch.cmd.main.main(argv)`` in this process: (exit code,
    standard output)."""
    import contextlib
    import io

    from tfk8s_tpu_torch.cmd.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _get(port, path):
    """(status, content type, body) of a GET on ``127.0.0.1:port``."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def _copy_checkpoint(src, step, dst):
    """Checkpoint ``step`` of directory ``src`` (its state and its commit
    marker) alone in a new directory ``dst``."""
    from tfk8s_tpu_torch.runtime.checkpoint import _COMMITS_DIRNAME

    shutil.copytree(os.path.join(src, str(step)), os.path.join(dst, str(step)))
    os.makedirs(os.path.join(dst, _COMMITS_DIRNAME))
    shutil.copy(os.path.join(src, _COMMITS_DIRNAME, str(step)),
                os.path.join(dst, _COMMITS_DIRNAME, str(step)))


def _operator_priority(torch, fa, server, kubeconfig, work, then=None):
    """Jobs (c) and (d) of phase operator on ``server``, the leader after
    the hand-over and the kill (docstring phase 24): (c) is preempted by
    (d), resumes from its checkpoint, is suspended and resumed through the
    verbs and succeeds. Each pod run of either job is one ``_recorded``
    record, with the checkpoint step it found; ``_update_hook`` counts its
    updates. ``then()`` is called once both jobs have succeeded, before the
    direct calls. Returns (the summary, the two jobs' flash launches)."""
    from tfk8s_tpu_torch.api import helpers, serde
    from tfk8s_tpu_torch.api.types import (ContainerSpec, JobConditionType, ObjectMeta,
                                           ReplicaSpec, ReplicaType, RunPolicy,
                                           SchedulingPolicy, TPUJob, TPUJobSpec, TPUSpec)
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
    from tfk8s_tpu_torch.runtime import registry
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
    from tfk8s_tpu_torch.trainer import labels as L
    from tfk8s_tpu_torch.trainer.replicas import CHECKPOINT_DIR_ANNOTATION

    cfg = OPERATOR
    low, high = OPERATOR_LOW[0], OPERATOR_HIGH[0]
    ckpt_dir = os.path.join(work, "low-ckpt")
    runs = {low: [], high: []}
    # (c)'s first run waits after update preempt_at, its second after
    # suspend_after, each until its pod's stop signal is set
    holds = {(low, 0): cfg["preempt_at"], (low, 1): cfg["suspend_after"]}

    def probe(name):
        def extra(rec):  # the checkpoint a run finds, copied for the direct call
            ckpt = Checkpointer(rec["env"].get("TFK8S_CHECKPOINT_DIR", ""))
            at = rec["ckpt_step_at_start"] = ckpt.latest_step() if ckpt.enabled else None
            ckpt.close()
            if (name, rec["index"]) in holds:
                rec["hold_at"], rec["hold"] = holds[name, rec["index"]], rec["stop"]
            if at:
                rec["ckpt_copy"] = os.path.join(work, f"{name}-resume-{rec['index']}")
                _copy_checkpoint(ckpt_dir, at, rec["ckpt_copy"])
        return extra

    manifests = {}
    for name, entrypoint, priority in (OPERATOR_LOW, OPERATOR_HIGH):
        steps = cfg["low_steps"] if name == low else cfg["high_steps"]
        env = _pod_env("gpt", POD_GPT, None, steps)
        annotations = {}
        if name == low:
            env["TFK8S_CHECKPOINT_EVERY"] = str(cfg["ckpt_every"])
            annotations[CHECKPOINT_DIR_ANNOTATION] = ckpt_dir
        job = TPUJob(
            metadata=ObjectMeta(name=name, annotations=annotations),
            spec=TPUJobSpec(
                replica_specs={ReplicaType.WORKER: ReplicaSpec(
                    replicas=1, template=ContainerSpec(entrypoint=entrypoint, env=env))},
                tpu=TPUSpec(accelerator="h100-1"),
                run_policy=RunPolicy(backoff_limit=0, scheduling=SchedulingPolicy(
                    gang=True, priority=priority))))
        manifests[name] = os.path.join(work, f"{name}.json")
        with open(manifests[name], "w") as f:
            json.dump(serde.to_wire(job), f)
        registry.register(entrypoint, _recorded(torch, fa, runs, name, pod_entry, probe(name)))
    client = clientset_from_kubeconfig(kubeconfig)
    kc = ["--kubeconfig", kubeconfig]

    def status(name):
        return client.tpujobs().get(name).status

    def live_pods(name):
        pods, _ = client.pods().list(label_selector={L.JOB_NAME: name})
        return [p for p in pods if p.metadata.deletion_timestamp is None
                and p.status.phase.value in ("Pending", "Running")]

    def until(pred, what):
        deadline = time.monotonic() + cfg["timeout_s"]
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"{what} within {cfg['timeout_s']:.0f} s: "
                                     f"{ {n: len(r) for n, r in runs.items()} } runs, "
                                     f"(c) {status(low)}")
            time.sleep(0.01)

    def ran(name, i, key):
        return len(runs[name]) > i and key in runs[name][i]

    def succeeded(name):
        return helpers.has_condition(status(name), JobConditionType.SUCCEEDED)

    verbs, t, out = {}, {}, {}
    try:
        # the section's launches, not each run's: (d) starts while (c)'s
        # preempted run still drains (the kubelet counts no devices)
        torch.cuda.synchronize()
        fa.reset_launches()
        verbs["submit_c"] = _verb(["submit", "--file", manifests[low]] + kc)
        until(lambda: ran(low, 0, "held"), "(c) did not reach its update "
              f"{cfg['preempt_at']}")
        c_pod = client.pods().get(f"{low}-worker-0")
        t["submit_d"] = time.perf_counter()
        verbs["submit_d"] = _verb(["submit", "--file", manifests[high]] + kc)
        until(lambda: ran(low, 0, "end"), "(c)'s pod did not end after (d) came")
        pods, _ = client.pods().list(label_selector={L.JOB_NAME: low})
        out["c_pod_phase"] = next((p.status.phase.value for p in pods
                                   if p.metadata.uid == c_pod.metadata.uid), "deleted")
        st = status(low)
        out["preempted"] = {"preemptions": st.preemptions, "gang_restarts": st.gang_restarts}
        until(lambda: ran(high, 0, "end") and succeeded(high), "(d) did not succeed")
        until(lambda: ran(low, 1, "held"), f"(c) did not resume to {cfg['suspend_after']} "
              "updates")
        t["suspend"] = time.perf_counter()
        verbs["suspend"] = _verb(["suspend", low] + kc)
        until(lambda: ran(low, 1, "end")
              and helpers.has_condition(status(low), JobConditionType.SUSPENDED)
              and not live_pods(low), "(c) did not park")
        st = status(low)
        out["suspended"] = {"preemptions": st.preemptions, "gang_restarts": st.gang_restarts,
                            "conditions": [c.type.value for c in st.conditions if c.status],
                            "live_pods": len(live_pods(low))}
        t["resume"] = time.perf_counter()
        verbs["resume"] = _verb(["resume", low] + kc)
        until(lambda: ran(low, 2, "end") and succeeded(low), "(c) did not succeed")
        torch.cuda.synchronize()
        launches = {k: fa.LAUNCHES[k] for k in fa.KERNELS}
        if then is not None:
            then()
        out["final"] = {n: {"conditions": [c.type.value for c in status(n).conditions
                                           if c.status],
                            "preemptions": status(n).preemptions,
                            "gang_restarts": status(n).gang_restarts} for n in (low, high)}
        out["reasons"] = {n: list(dict.fromkeys(e.reason for e in server.recorder.events(
            key=f"default/{n}"))) for n in (low, high)}
    finally:
        for _name, entrypoint, _priority in (OPERATOR_LOW, OPERATOR_HIGH):
            registry._REGISTRY.pop(entrypoint, None)

    c_runs, (d_run,) = runs[low], runs[high]
    out["runs"] = [{"gang_restarts": r["env"].get("TFK8S_GANG_RESTARTS"),
                    "ckpt_step_at_start": r["ckpt_step_at_start"],
                    "steps": [h["step"] for h in r["history"]],
                    "first_loss": r["history"][0]["loss"] if r["history"] else None,
                    "start_to_first_step_s": r["first_step"] - r["start"],
                    "wall_s": r["end"] - r["start"]} for r in c_runs + [d_run]]
    out["preemption_s"] = {"to_c_stop": c_runs[0]["stopped"] - t["submit_d"],
                           "to_c_pod_end": c_runs[0]["end"] - t["submit_d"],
                           "to_d_first_update": d_run["first_step"] - t["submit_d"]}
    # (c) goes on once (d) has ended and released the host; once resumed
    out["resume_s"] = {"after_preemption": c_runs[1]["first_step"] - d_run["end"],
                       "after_resume_verb": c_runs[2]["first_step"] - t["resume"]}
    out["suspend_to_end_s"] = c_runs[1]["end"] - t["suspend"]
    # each (c) run's entry after its predecessor's end: the kubelet holds a
    # pod recreated under a live pod's name until that pod's thread ends
    out["c_entry_after_previous_end_s"] = [b["entered"] - a["end"]
                                           for a, b in zip(c_runs, c_runs[1:])]
    # (d)'s entry after (c)'s preempted run ended (< 0: they overlapped on
    # the card; the kubelet counts no devices, ROADMAP queue 3)
    out["d_entry_after_c_end_s"] = d_run["entered"] - c_runs[0]["end"]    # each resumed run's first loss against a direct call on its env, resumed
    # from a copy of the same checkpoint
    out["direct"] = []
    for r in c_runs[1:]:
        env = dict(r["env"], TFK8S_CHECKPOINT_DIR=r["ckpt_copy"],
                   TFK8S_TRAIN_STEPS=str(r["ckpt_step_at_start"] + 1))
        direct = pod_entry(env)
        out["direct"].append({"step": direct[0]["step"], "loss": direct[0]["loss"],
                              "diff": abs(direct[0]["loss"] - r["history"][0]["loss"])})
    out["launches"] = launches
    log(f"operator: preemption and suspend {json.dumps(out)}")

    bad = []
    if [v for v in verbs.values() if v[0] != 0]:
        bad.append(f"verbs {verbs}")
    if out["final"][low]["conditions"][-1:] != ["Succeeded"] or out["final"][high][
            "conditions"][-1:] != ["Succeeded"]:
        bad.append(f"the jobs ended {out['final']}")
    if out["preempted"] != {"preemptions": 1, "gang_restarts": 0}:
        bad.append(f"(c) after (d) came: {out['preempted']}, want one preemption, no restart")
    if ("Preempted" not in out["reasons"][low] or "PreemptedOther" not in out["reasons"][high]
            or "JobSuspended" not in out["reasons"][low]):
        bad.append(f"event reasons {out['reasons']}")
    if [r["gang_restarts"] for r in out["runs"][:3]] != ["0", "1", "2"]:
        bad.append(f"(c)'s runs were rendered with TFK8S_GANG_RESTARTS "
                   f"{[r['gang_restarts'] for r in out['runs'][:3]]}, want 0, 1, 2")
    for prev, r in zip(c_runs, c_runs[1:]):
        at = r["ckpt_step_at_start"]
        if not at or at != prev["history"][-1]["step"] or r["history"][0]["step"] != at + 1:
            bad.append(f"(c) resumed at step {r['history'][0]['step']} from checkpoint {at}, "
                       f"its last run ended at {prev['history'][-1]['step']}")
    if any(s < 0 for s in out["c_entry_after_previous_end_s"]):
        bad.append("a run of (c) started before its predecessor ended: "
                   f"{out['c_entry_after_previous_end_s']} s")
    if not all(r.get("hold_seen") for r in c_runs[:2]):
        bad.append("(c)'s pod was not stopped while it waited at its update")
    if out["suspended"]["preemptions"] != 2 or out["suspended"]["live_pods"] or (
            "Suspended" not in out["suspended"]["conditions"]):
        bad.append(f"(c) after the suspend verb: {out['suspended']}")
    if c_runs[-1]["history"][-1]["step"] != cfg["low_steps"] or len(d_run["history"]) != cfg[
            "high_steps"]:
        bad.append(f"(c) ended at {c_runs[-1]['history'][-1]['step']}, (d) ran "
                   f"{len(d_run['history'])} steps")
    if any(not d["diff"] <= cfg["loss_atol"] for d in out["direct"]):
        bad.append(f"resumed first losses against direct calls: {out['direct']}")
    steps = sum(len(r["history"]) for r in c_runs + [d_run])
    if launches != _flash(fa, 1, GANG_LAYERS, steps):
        bad.append(f"(c) and (d) flash launches {launches}, want {GANG_LAYERS} layers x "
                   f"{steps} steps")
    if bad:
        raise AssertionError(f"jobs (c) and (d): {bad}")
    return out, launches


# a node agent's process: its runtime warmed (torch imported, the card's
# context made, job (e)'s modules imported, and what a training pod's first
# update and first save import: torch's AdamW imports torch._dynamo, the
# port's state_dicts the DCP state-dict helpers), then, once the file
# NODE_JOIN names exists, the ``kubelet`` verb through the ``main`` that
# ``python -m tfk8s_tpu_torch.cmd.main`` runs
_NODE_MAIN = """\
import os, sys, time
t0 = time.perf_counter()
import torch
if torch.cuda.is_available():
    torch.cuda.init()
import torch._dynamo
import torch.distributed.checkpoint.state_dict
import chip_smoke
from tfk8s_tpu_torch.models import gpt
from tfk8s_tpu_torch.ops import flash_attention
from tfk8s_tpu_torch.cmd.main import main
print(f"node warmed in {time.perf_counter() - t0:.2f} s", flush=True)
while not os.path.exists(os.environ["NODE_JOIN"]):
    time.sleep(0.02)
sys.exit(main(sys.argv[1:]))
"""


class _KubeletProcess:
    """The ``kubelet --kubeconfig ... --name <name>`` verb in a process of
    its own (``_NODE_MAIN``), from the root of the checkout (so its pods
    resolve ``chip_smoke:...``), with ``env`` added to its environment; its
    log in ``work/<name>.log``. The node joins the cluster (its kubelet
    starts) at ``join()``, once its runtime has warmed."""

    def __init__(self, root, work, kubeconfig, name, env=None):
        self.name, self.log_path = name, os.path.join(work, f"{name}.log")
        self.gate, self.joined = os.path.join(work, f"{name}.join"), None
        with open(self.log_path, "wb") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _NODE_MAIN, "kubelet",
                 "--kubeconfig", kubeconfig, "--name", name],
                cwd=root, env=dict(os.environ, PYTHONPATH=root, NODE_JOIN=self.gate,
                                   **(env or {})),
                stdout=out, stderr=subprocess.STDOUT)

    def join(self):
        self.joined = time.perf_counter()
        open(self.gate, "w").close()

    def warmed_s(self):
        """The seconds its runtime took to warm, from its log."""
        found = re.search(r"node warmed in ([0-9.]+) s", self.tail())
        return float(found.group(1)) if found else None

    def kill(self):
        """SIGKILL, as the node's loss would end it."""
        import signal

        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)

    def stop(self):
        if self.proc.poll() is None:
            self.kill()

    def tail(self):
        with open(self.log_path, errors="replace") as f:
            return f"--- {self.name}\n" + f.read()[-3000:]


def _operator_nodes(root, work, kubeconfig):
    """Job (e)'s node agents, warming while (c) and (d) run: node-a with
    a short node lease (``TFK8S_NODE_LEASE_*``), node-b with the default
    one."""
    cfg = OPERATOR
    return {"node-a": _KubeletProcess(root, work, kubeconfig, "node-a", {
                "TFK8S_NODE_LEASE_DURATION_S": str(cfg["node_lease_s"]),
                "TFK8S_NODE_LEASE_RENEW_S": str(cfg["node_renew_s"])}),
            "node-b": _KubeletProcess(root, work, kubeconfig, "node-b")}


def _operator_lost_start(work, kubeconfig, lost):
    """Job (e)'s start, once (c) and (d) have succeeded and the phase's
    in-process kubelet has stopped: node-a joins (``lost["nodes"]``), then
    (e) is sent with ``submit``, so its pod is node-a's. Adds to ``lost``
    what ``_operator_node_loss`` goes on from."""
    from tfk8s_tpu_torch.api import serde
    from tfk8s_tpu_torch.api.types import (ContainerSpec, ObjectMeta, ReplicaSpec,
                                           ReplicaType, RunPolicy, SchedulingPolicy, TPUJob,
                                           TPUJobSpec, TPUSpec)
    from tfk8s_tpu_torch.trainer.replicas import CHECKPOINT_DIR_ANNOTATION

    cfg = OPERATOR
    name, entrypoint = OPERATOR_LOST
    lost.update(records=os.path.join(work, "lost-records"),
                ckpt=os.path.join(work, "lost-ckpt"))
    os.makedirs(lost["records"])
    env = _pod_env("gpt", POD_GPT, None, cfg["lost_steps"])
    env.update(TFK8S_CHECKPOINT_EVERY=str(cfg["ckpt_every"]), NODE_LOSS_RECORDS=lost["records"],
               NODE_LOSS_HOLD_AT=str(cfg["lost_hold_at"]))
    job = TPUJob(
        metadata=ObjectMeta(name=name, annotations={CHECKPOINT_DIR_ANNOTATION: lost["ckpt"]}),
        spec=TPUJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=1, template=ContainerSpec(entrypoint=entrypoint, env=env))},
            tpu=TPUSpec(accelerator="h100-1"),
            run_policy=RunPolicy(backoff_limit=1, scheduling=SchedulingPolicy(gang=True))))
    manifest = os.path.join(work, f"{name}.json")
    with open(manifest, "w") as f:
        json.dump(serde.to_wire(job), f)
    lost["nodes"]["node-a"].join()
    lost["submit"] = _verb(["submit", "--file", manifest, "--kubeconfig", kubeconfig])


def _operator_node_loss(torch, fa, server, kubeconfig, lost):
    """Job (e) of phase operator (docstring phase 24) on ``server``, the
    leader, from ``_operator_lost_start``: node-b joins once (e)'s pod runs
    on node-a; node-a is killed with SIGKILL while (e) waits after update
    OPERATOR["lost_hold_at"] with step k's data written and its commit
    marker absent; (e) must resume on node-b from step k - 2. Returns (the
    summary, the resumed run's flash launches)."""
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
    from tfk8s_tpu_torch.client.store import NotFound
    from tfk8s_tpu_torch.runtime.checkpoint import _COMMITS_DIRNAME
    from tfk8s_tpu_torch.runtime.kubelet import NODE_LEASE_PREFIX
    from tfk8s_tpu_torch.trainer import labels as L

    cfg, (name, _entry) = OPERATOR, OPERATOR_LOST
    records, ckpt, nodes = lost["records"], lost["ckpt"], lost["nodes"]
    # the newest checkpoint step at the hold: its save started, none committed it
    k = (cfg["lost_hold_at"] - 1) // cfg["ckpt_every"] * cfg["ckpt_every"]
    client = clientset_from_kubeconfig(kubeconfig)
    leases = client.generic("Lease", "default")
    t, out = {}, {"submit": lost["submit"]}

    def pods():
        return client.pods().list(label_selector={L.JOB_NAME: name})[0]

    def watch():  # node-b's start: its joining to its first lease
        if nodes["node-b"].joined is not None and "node_b_lease" not in t:
            try:
                leases.get(NODE_LEASE_PREFIX + "node-b")
                t["node_b_lease"] = time.perf_counter()
            except NotFound:
                pass

    def until(pred, what):
        deadline = time.monotonic() + cfg["timeout_s"]
        while not pred():
            watch()
            dead = [n for n, p in nodes.items() if p.proc.poll() is not None and n not in t]
            if time.monotonic() > deadline or dead:
                raise AssertionError(f"(e): {what} within {cfg['timeout_s']:.0f} s (ended: "
                                     f"{dead})\n" + "\n".join(p.tail() for p in nodes.values()))
            time.sleep(0.05)

    def record(stem):
        with open(os.path.join(records, f"{stem}.json")) as f:
            return json.load(f)

    def marked(step):
        return os.path.exists(os.path.join(ckpt, _COMMITS_DIRNAME, str(step)))

    until(lambda: any(p.status.phase.value == "Running" and p.status.host == "node-a"
                      for p in pods()), "its pod did not run on node-a")
    nodes["node-b"].join()
    until(lambda: os.path.exists(os.path.join(records, "held.json"))
          and os.path.exists(os.path.join(ckpt, str(k), "state.pt")),
          f"it was not held with step {k}'s data written")
    out["at_kill"] = {"k": k, "k_marked": marked(k), "k_minus_2_marked": marked(k - 2)}
    listing = _listing(ckpt)
    t["node-a"], wall_kill = time.perf_counter(), time.time()  # node-a's end is expected
    nodes["node-a"].kill()
    # the committed step the job must resume from, copied for the direct call
    # while the operator finds the node lost
    resume_copy = os.path.join(records, "resume")
    _copy_checkpoint(ckpt, k - 2, resume_copy)

    def ended():
        conds = {c.type.value for c in client.tpujobs().get(name).status.conditions
                 if c.status}
        return conds & {"Succeeded", "Failed"}

    until(ended, "it did not end")
    st = client.tpujobs().get(name).status
    out["final"] = {"conditions": [c.type.value for c in st.conditions if c.status],
                    "gang_restarts": st.gang_restarts}
    out["pods"] = [[p.status.phase.value, p.status.host] for p in pods()]
    node_lost = [e for e in server.recorder.events(key=f"default/{name}")
                 if e.reason == "NodeLost"]
    out["node_lost"] = len(node_lost)
    held, start_b, run_b = record("held"), record("start-1"), record("run-1")
    out["node_a_ended_a_run"] = os.path.exists(os.path.join(records, "run-0.json"))
    out["written_after_kill"] = sorted(
        p for p in set(listing) | set(start_b["listing"])
        if listing.get(p) != start_b["listing"].get(p))
    history = run_b["history"]
    out["resumed"] = {"ckpt_step": start_b["ckpt_step"],
                      "steps": [h["step"] for h in history],
                      "first_loss": history[0]["loss"] if history else None}
    out["steps_lost"] = cfg["lost_hold_at"] - (start_b["ckpt_step"] or 0)
    out["seconds"] = {
        "hold_to_kill": wall_kill - held["at"],
        "kill_to_node_lost": node_lost[0].timestamp - wall_kill if node_lost else None,
        "kill_to_node_b_entry": start_b["entered"] - wall_kill,
        "node_b_entry_to_state_built": run_b["state_built"] - start_b["entered"],
        "state_built_to_first_update": run_b["first_update"] - run_b["state_built"],
        "kill_to_first_resumed_update": run_b["first_update"] - wall_kill,
        "node_b_start": t["node_b_lease"] - nodes["node-b"].joined if "node_b_lease" in t else None,
        "nodes_warmed": {n: p.warmed_s() for n, p in nodes.items()},
        "resumed_run": run_b["end"] - start_b["entered"]}
    out["peak_gib"] = run_b["peak_gib"]
    # the resumed run's first loss against a direct call on its env, resumed
    # from a copy of the same checkpoint
    direct = pod_entry(dict(start_b["env"], TFK8S_CHECKPOINT_DIR=resume_copy,
                            TFK8S_TRAIN_STEPS=str(k - 1)))
    out["direct"] = {"step": direct[0]["step"] if direct else None,
                     "diff": abs(direct[0]["loss"] - history[0]["loss"])
                     if direct and history else None}
    out["launches"] = run_b["launches"]
    log(f"operator: node loss {json.dumps(out)}")

    bad = []
    if out["submit"] != (0, f"tpujob default/{name} created\n"):
        bad.append(f"submit {out['submit']}")
    if out["at_kill"] != {"k": k, "k_marked": False, "k_minus_2_marked": True}:
        bad.append(f"at the kill {out['at_kill']}, want step {k} written and unmarked, "
                   f"{k - 2} committed")
    if out["final"]["conditions"][-1:] != ["Succeeded"] or out["final"]["gang_restarts"] != 1:
        bad.append(f"it ended {out['final']}, want Succeeded after one gang restart")
    if out["node_lost"] != 1:
        bad.append(f"NodeLost recorded {out['node_lost']} times, want once")
    if out["pods"] != [["Succeeded", "node-b"]]:
        bad.append(f"its pods {out['pods']}, want one Succeeded on node-b")
    if out["node_a_ended_a_run"] or out["written_after_kill"]:
        bad.append(f"node-a ended a run or wrote {out['written_after_kill']} after the kill")
    if out["resumed"]["ckpt_step"] != k - 2 or out["resumed"]["steps"] != list(
            range(k - 1, cfg["lost_steps"] + 1)):
        bad.append(f"resumed {out['resumed']}, want steps {k - 1}-{cfg['lost_steps']} from "
                   f"checkpoint {k - 2}")
    if out["direct"]["diff"] is None or not out["direct"]["diff"] <= cfg["loss_atol"]:
        bad.append(f"resumed first loss against the direct call: {out['direct']}")
    if run_b["launches"] != _flash(fa, 1, GANG_LAYERS, len(history)):
        bad.append(f"the resumed run's flash launches {run_b['launches']}, want "
                   f"{GANG_LAYERS} layers x {len(history)} steps")
    if bad:
        raise AssertionError(f"job (e): {bad}\n" + "\n".join(p.tail() for p in nodes.values()))
    return out, run_b["launches"]


def phase_operator(torch, gpt, fa, root):
    """The example manifest's GPT-2-small TPUJob sent with the port's
    ``submit`` verb to two leader-elected operators, handed over mid-job,
    a second job gang-pending behind it, the verbs and the endpoint after,
    and the first job's history against a direct ``gpt:train`` call
    (docstring phase 24), then jobs (c) and (d) on the new leader
    (``_operator_priority``) and (e) through two kubelet processes, the
    first killed with SIGKILL mid-job (``_operator_node_loss``). Returns
    the launches of the five jobs (of (e), its resumed run's)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from tfk8s_tpu_torch.api import serde
    from tfk8s_tpu_torch.api.types import ReplicaType
    from tfk8s_tpu_torch.cmd.main import load_manifest
    from tfk8s_tpu_torch.runtime import registry
    from tfk8s_tpu_torch.runtime.kubelet import LocalKubelet

    t_phase = time.perf_counter()
    card = phase_card()
    try:
        import cryptography

        tls = True
        log(f"operator: cryptography {cryptography.__version__} imports: the apiserver "
            "serves HTTPS")
    except ImportError as e:
        tls = False
        log(f"operator: cryptography does not import ({e}): the apiserver serves plain HTTP")
    job_a = load_manifest(os.path.join(root, OPERATOR["manifest"]))
    tmpl_a = job_a.spec.replica_specs[ReplicaType.WORKER].template
    if DEVICE == "cpu":  # the CPU rehearsal
        tmpl_a.env["TFK8S_DEVICE"] = "cpu"
    steps = int(tmpl_a.env["TFK8S_TRAIN_STEPS"])
    layers = family_layers(gpt, tmpl_a.env)
    job_b = serde.decode_object(serde.to_wire(job_a))
    job_b.metadata.name = "gpt-h100-gang"
    tmpl_b = job_b.spec.replica_specs[ReplicaType.WORKER].template
    tmpl_b.entrypoint = OPERATOR_GANG_ENTRY
    tmpl_b.env = _pod_env("gpt", POD_GPT, None, OPERATOR["gang_steps"])
    names = (job_a.metadata.name, job_b.metadata.name)

    runs = {"a": [], "b": []}
    resume = threading.Event()  # set once (a) may go on after its first update

    def hold_a(rec):  # (a) stays mid-job until the hand-over and the kill are done
        rec["hold_at"], rec["hold"] = 1, resume

    def run_a():  # (a)'s one run, once it has started
        return runs["a"][0] if runs["a"] else {}

    # the manifest's entry point resolves to gpt:train through a recorder
    registry.register(tmpl_a.entrypoint, _recorded(torch, fa, runs, "a", gpt.train, hold_a))
    registry.register(OPERATOR_GANG_ENTRY, _recorded(torch, fa, runs, "b", pod_entry))
    work = os.path.join(root, "build", "chip_smoke_operator")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    manifests = {}
    for key, job in zip("ab", (job_a, job_b)):
        manifests[key] = os.path.join(work, f"{job.metadata.name}.json")
        with open(manifests[key], "w") as f:
            json.dump(serde.to_wire(job), f)
    api = _APIServerProcess(root, work, tls)
    wire = {"scheme": "https" if tls else "http"}
    handle = register_optimizer_step_post_hook(_update_hook(torch))
    ops, kubelet_stop = {}, threading.Event()
    pending, leaders, verbs, endpoint, lost = [], [], {}, {}, {}
    handed = {"over": False}

    def leads(ident):
        elector = getattr(ops[ident][0], "elector", None) if ident in ops else None
        return bool(elector and elector.is_leader)

    def watch(states):  # (b) waits, podless, while (a) has not ended; who leads
        leaders.append((handed["over"], leads("op-a"), leads("op-b")))
        conds_a, _reasons_a, _pods_a = states[names[0]]
        _conds_b, reasons_b, pods_b = states[names[1]]
        if "GangPending" in reasons_b and not {"Succeeded", "Failed"} & set(conds_a):
            pending.append(len(pods_b))

    def poll():
        lead = ops["op-b" if handed["over"] else "op-a"][0]
        recorders = [server.recorder for server, _stop in ops.values()]
        return {n: _job_state(lead, n, recorders) for n in reversed(names)}

    try:
        from tfk8s_tpu_torch.client.remote import (clientset_from_kubeconfig, load_kubeconfig,
                                                   store_from_kubeconfig)

        wire["start_s"] = api.start()
        wire["start_listening_s"] = api.listening_s()
        wire["start_imports"] = api.imports()
        # one node agent of its own, so that stopping an operator leaves the pods
        node0 = LocalKubelet(clientset_from_kubeconfig(api.kubeconfig), name="node-0")
        node0.run(kubelet_stop)
        for ident in ("op-a", "op-b"):
            ops[ident] = _operator_server(
                {"h100-1": 1}, kubeconfig=api.kubeconfig, leader_elect=True, identity=ident,
                lease_duration_s=OPERATOR["lease_s"], local_kubelet=False)
            if ident == "op-a":
                deadline = time.monotonic() + 30
                while not leads("op-a") and time.monotonic() < deadline:
                    time.sleep(0.01)
                if not leads("op-a"):
                    raise AssertionError("op-a did not take the lease within 30 s")
        for server, _stop in ops.values():
            if type(server.store).__name__ != "RemoteStore":
                raise AssertionError(f"the operator's store is a {type(server.store).__name__}")
        # the jobs go over the wire through the port's submit verb
        raw = store_from_kubeconfig(load_kubeconfig(api.kubeconfig))
        client = clientset_from_kubeconfig(api.kubeconfig)
        submitted = {}
        submitted["a"] = time.perf_counter()
        verbs["submit_a"] = _verb(["submit", "--kubeconfig", api.kubeconfig,
                                   "--file", manifests["a"]])
        deadline = time.monotonic() + OPERATOR["timeout_s"]
        while not runs["a"] and time.monotonic() < deadline:
            time.sleep(0.01)
        submitted["b"] = time.perf_counter()
        verbs["submit_b"] = _verb(["submit", "--kubeconfig", api.kubeconfig,
                                   "--file", manifests["b"]])
        for key in "ab":
            want = f"tpujob default/{names['ab'.index(key)]} created\n"
            if verbs[f"submit_{key}"] != (0, want):
                raise AssertionError(f"submit of ({key}): {verbs[f'submit_{key}']}")
        # (a)'s first finished update holds it mid-job
        polled = 0.0
        while ("first_step" not in run_a() and "end" not in run_a()
               and time.monotonic() < deadline):
            if time.monotonic() - polled > 0.1:
                polled = time.monotonic()
                watch(poll())
            time.sleep(0.005)
        watch(poll())
        # the leader stops gracefully: it releases the lease to the standby
        wire["a_running_at_handover"] = (
            "end" not in run_a()
            and "Running" in _job_state(ops["op-a"][0], names[0])[0])
        t_stop = time.perf_counter()
        handed["over"] = True
        ops["op-a"][1].set()
        ops["op-a"][0].shutdown()
        deadline_lead = time.monotonic() + 30
        while not leads("op-b") and time.monotonic() < deadline_lead:
            time.sleep(0.005)
        wire["failover_s"] = time.perf_counter() - t_stop if leads("op-b") else None
        # kill -9 while (a) is held after its first update; restart from the journal
        wire["rv_before_kill"] = raw.list("TPUJob")[1]
        server = ops["op-b"][0]
        relists = _relists(server)
        t_kill = time.perf_counter()
        api.kill()
        resume.set()
        wire["a_ended_before_kill"] = "end" in run_a()
        wire["restart_s"] = api.start()
        wire["outage_s"] = time.perf_counter() - t_kill
        wire["restart_listening_s"] = api.listening_s()
        wire["restart_imports"] = api.imports()
        wire["rv_after_restart"] = raw.list("TPUJob")[1]
        states = _wait_jobs(server, names, OPERATOR["timeout_s"], watch,
                            [srv.recorder for srv, _stop in ops.values()])
        wire["relists"] = _relists(server) - relists
        wire["gang_restarts"] = {n: client.tpujobs().get(n).status.gang_restarts for n in names}
        # (b)'s pod, from the store: made only once (a) had completed
        a_done = client.tpujobs().get(names[0]).status.completion_time
        b_pods = states[names[1]][2]
        wire["b_pod_after_a_s"] = (b_pods[0].metadata.creation_timestamp - a_done
                                   if b_pods and a_done else None)
        # lease threads left once the apiserver is back (both packages' electors
        # end on a transport error: ROADMAP queue 3)
        wire["renewers_alive"] = sum(t.name == "lease-renewer" for t in threading.enumerate())
        # (c) and (d) on the new leader: a preemption, a suspend and two resumes;
        # once both succeeded the phase's kubelet stops and (e) starts on node-a
        def start_lost():
            # a stopped kubelet's informer still hands on what its watch
            # delivers within its next poll (both packages): joined, it
            # takes no pod
            kubelet_stop.set()
            node0.informer.join(10)
            _operator_lost_start(work, api.kubeconfig, lost)
            wire["lost_started"] = time.perf_counter()

        t_priority = time.perf_counter()
        lost["nodes"] = _operator_nodes(root, work, api.kubeconfig)
        _, priority_launches = _operator_priority(torch, fa, server, api.kubeconfig,
                                                  work, then=start_lost)
        wire["priority_s"] = time.perf_counter() - t_priority
        # (e): node-a killed with SIGKILL mid-save, the job resumed on node-b
        _, lost_launches = _operator_node_loss(torch, fa, server, api.kubeconfig, lost)
        wire["lost_s"] = time.perf_counter() - wire.pop("lost_started")
        # the verbs, as a user reads the jobs, and the new leader's endpoint
        for srv, _stop in ops.values():
            srv.recorder.flush()
        kc = ["--kubeconfig", api.kubeconfig]
        verbs["get"] = _verb(["get"] + kc)
        verbs["get_json"] = _verb(["get", names[0], "-o", "json"] + kc)
        verbs["describe"] = _verb(["describe", names[0]] + kc)
        verbs["logs"] = _verb(["logs", "--job", names[0]] + kc)
        port = server.start_metrics_server(0)
        for path in ("/healthz", "/metrics", f"/events?key=default/{names[0]}"):
            endpoint[path.split("?")[0]] = _get(port, path)
    finally:
        resume.set()
        kubelet_stop.set()
        for node in lost.get("nodes", {}).values():
            node.stop()
        for server, stop in ops.values():
            stop.set()
            server.shutdown()
            for t in server._threads:
                t.join(10)
        api.stop()
        handle.remove()
        for entry in (tmpl_a.entrypoint, OPERATOR_GANG_ENTRY):
            registry._REGISTRY.pop(entry, None)
    jobs_s = time.perf_counter() - t_phase

    # the same env, called directly in this process
    rec_a, rec_b = run_a(), (runs["b"][0] if runs["b"] else {})
    direct = gpt.train(dict(rec_a["env"]))
    losses = [h["loss"] for h in rec_a["history"]]
    direct_losses = [h["loss"] for h in direct]
    diff = max(abs(a - b) for a, b in zip(losses, direct_losses)) if direct else float("inf")

    summary = {"card": card, "phase_s": time.perf_counter() - t_phase, "jobs_s": jobs_s,
               "wire": wire, "a_held_s": rec_a.get("stopped", 0) - rec_a.get("held", 0)}
    for rec, key, name in zip((rec_a, rec_b), "ab", names):
        conds, reasons, pods = states[name]
        summary[name] = {
            "conditions": conds, "reasons": list(dict.fromkeys(reasons)),
            "pods": [{"name": p.metadata.name, "phase": p.status.phase.value,
                      "resources": p.spec.containers[0].resources,
                      "training_step": p.status.training.get("step")} for p in pods],
            "submit_to_first_step_s": (rec["first_step"] - submitted[key]
                                       if "first_step" in rec else None),
            "wall_s": rec["end"] - rec["start"] if "end" in rec else None,
            "peak_gib": rec.get("peak_gib"), "launches": rec.get("launches")}
    b_after = wire["b_pod_after_a_s"]
    b_waited = (not pending or max(pending) == 0) and b_after is not None and b_after >= 0
    before = [(a, b) for over, a, b in leaders if not over]
    after = [(a, b) for over, a, b in leaders if over]
    summary.update(losses=losses, direct_losses=direct_losses, identical=losses == direct_losses,
                   loss_max_abs_diff=diff, b_waited_podless=b_waited,
                   b_polled_pending=len(pending),
                   leader_samples={"before": len(before), "after": len(after),
                                   "both": sum(a and b for a, b in before + after)})
    log(f"operator: {json.dumps(summary)}")
    # op-a stopped before (a) ended: only op-b's reconciles can have
    # counted (a)'s success and (b)'s on op-b's registry
    metrics = endpoint.get("/metrics", (None, None, ""))[2]
    series = "tpujob_succeeded_total"
    value = _series(metrics, series)
    log(f"operator: verbs {json.dumps({k: [rc, len(out)] for k, (rc, out) in verbs.items()})}, "
        f"endpoint {json.dumps({k: [v[0], v[1], len(v[2])] for k, v in endpoint.items()})}, "
        f"{series} {value}")

    for key, name in zip("ab", names):
        conds, _reasons, pods = states[name]
        if conds[-1:] != ["Succeeded"]:
            raise AssertionError(f"job {name} ended {conds}")
        if [p.spec.containers[0].resources for p in pods] != [{"nvidia.com/gpu": "1"}]:
            raise AssertionError(f"job {name}'s pods request {summary[name]['pods']}")
    if states[names[0]][2][0].status.training.get("step") != steps:
        raise AssertionError(f"job {names[0]}'s pod status lacks its progress")
    if wire["gang_restarts"] != dict.fromkeys(names, 0):
        raise AssertionError(f"the jobs restarted across the hand-over or the kill: {wire}")
    if (wire["a_ended_before_kill"] or not wire["a_running_at_handover"]
            or not rec_a.get("hold_seen")):
        raise AssertionError(f"job (a) was not mid-job at the hand-over and the kill: {wire}, "
                             f"held {summary['a_held_s']} s")
    if not wire["rv_after_restart"] >= wire["rv_before_kill"]:
        raise AssertionError(f"the restarted apiserver's resource_version went back: {wire}")
    if wire["failover_s"] is None or wire["failover_s"] > OPERATOR["failover_limit_s"]:
        raise AssertionError(f"op-b took the lease {wire['failover_s']} s after op-a stopped, "
                             f"limit {OPERATOR['failover_limit_s']} s")
    if (not before or any(s != (True, False) for s in before)
            or any(a and b for a, b in after) or not after or after[-1] != (False, True)):
        raise AssertionError(f"not one leader at a time: before {before}, after {after}")
    _check_verbs(verbs, endpoint, names[0], series,
                 [r for r in summary[names[0]]["reasons"]])
    if _series(metrics, "tpujob_node_lost_pods_total") != 1:
        raise AssertionError("the leader's /metrics counts tpujob_node_lost_pods_total "
                             f"{_series(metrics, 'tpujob_node_lost_pods_total')}, want 1")
    want = {"a": _flash(fa, 1, layers, steps),
            "b": _flash(fa, 1, GANG_LAYERS, OPERATOR["gang_steps"])}
    for key, rec in zip("ab", (rec_a, rec_b)):
        if rec["launches"] != want[key]:
            raise AssertionError(f"job {key} flash launches {rec['launches']}, "
                                 f"want {want[key]}")
    if (not b_waited or "GangPending" not in states[names[1]][1]
            or rec_b["start"] < rec_a["end"]):
        raise AssertionError("the second h100-1 job did not wait for the first one's host")
    if len(direct_losses) != steps or not diff <= OPERATOR["loss_atol"]:
        raise AssertionError(f"the operator's losses {losses} differ from a direct call's "
                             f"{direct_losses} by {diff}")
    if summary["phase_s"] > OPERATOR["limit_s"]:
        raise AssertionError(f"the operator phase took {summary['phase_s']:.1f} s, over its "
                             f"{OPERATOR['limit_s']:.0f} s limit")
    return {k: rec_a["launches"][k] + rec_b["launches"][k] + priority_launches[k]
            + lost_launches[k] for k in fa.KERNELS}


def _series(text, name):
    """The value of the unlabelled series ``name`` in a Prometheus
    exposition, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def _check_verbs(verbs, endpoint, name, series, reasons):
    """The verbs' and the endpoint's outputs for job ``name``, ended
    ``Succeeded``: ``get`` (table and JSON), ``describe`` listing its event
    reasons, ``logs --job`` with a header and a tail; ``/healthz``,
    ``/metrics`` counting both jobs in ``series``, ``/events`` holding its
    events."""
    bad = [k for k, (rc, _out) in verbs.items() if rc != 0]
    rows = [line.split() for line in verbs["get"][1].splitlines()]
    row = next((r for r in rows if r and r[0] == name), None)
    if row is None or row[1:3] != ["Succeeded", "0"]:
        bad.append(f"get: {verbs['get'][1]!r}")
    wire = json.loads(verbs["get_json"][1])
    conds = [c["type"] for c in wire[0]["status"]["conditions"] if c["status"]]
    if conds[-1:] != ["Succeeded"]:
        bad.append(f"get -o json: {conds}")
    described = verbs["describe"][1].split("\nEvents:\n")
    listed = [line.split()[1] for line in described[-1].splitlines()] if len(described) == 2 else []
    # the operators mirror their events into the cluster best-effort: one
    # recorded while the apiserver was down may be missing
    if not {"JobCreated", "JobSucceeded"} <= set(listed) <= set(reasons):
        bad.append(f"describe lists {listed}, the operators recorded {reasons}")
    out = verbs["logs"][1].splitlines()
    header = [i for i, line in enumerate(out) if line.startswith("==> default/")
              and line.endswith("(Succeeded) <==")]
    if len(header) != 1 or len(out) <= header[0] + 1:
        bad.append(f"logs --job: {out[:3]} ... ({len(out)} lines)")
    if endpoint.get("/healthz", (None,))[:3] != (200, "text/plain", "ok"):
        bad.append(f"/healthz: {endpoint.get('/healthz')}")
    code, ctype, metrics = endpoint.get("/metrics", (None, None, ""))
    if (code, ctype) != (200, "text/plain; version=0.0.4") or not _series(metrics, series) >= 2:
        bad.append(f"/metrics ({code}, {ctype}): {series} {_series(metrics, series)}, want >= 2")
    code, _ctype, body = endpoint.get("/events", (None, None, "[]"))
    evs = json.loads(body)
    if code != 200 or not evs or {e["key"] for e in evs} != {f"default/{name}"}:
        bad.append(f"/events?key=default/{name}: {code} {evs[:3]}")
    if bad:
        raise AssertionError(f"the verbs or the endpoint: {bad}")


def _relists(server):
    """The relists the operator's informers have begun so far (a failed
    attempt during an outage counts too)."""
    return sum(v for k, v in server.metrics.snapshot()["counters"].items()
               if k.startswith("informer.relists_total"))


def _operator_nccl(torch, fa):
    """An ``h100-4`` TPUJob through the port's operator: one pod requesting
    four cards, whose entry point runs GPT-2-small at full depth on
    ``{"data": 4}`` as four NCCL ranks, a card each."""
    from tfk8s_tpu_torch.api.types import (ContainerSpec, ObjectMeta, ReplicaSpec, ReplicaType,
                                           TPUJob, TPUJobSpec, TPUSpec)
    from tfk8s_tpu_torch.runtime import pod_ranks, registry

    runs = {}

    def entry(env, stop):
        runs["history"] = pod_entry(env, stop)
        runs["pod"] = pod_ranks.last_run()

    name, steps = "gpt-h100-4", POD["gang_steps"]
    registry.register("chip_smoke.operator_nccl", entry)
    job = TPUJob(metadata=ObjectMeta(name=name), spec=TPUJobSpec(
        replica_specs={ReplicaType.WORKER: ReplicaSpec(replicas=1, template=ContainerSpec(
            entrypoint="chip_smoke.operator_nccl",
            env=_pod_env("gpt", POD_GPT, None, steps, layers=None)))},
        tpu=TPUSpec(accelerator="h100-4")))
    server, stop = _operator_server({"h100-4": 1})
    t0 = time.perf_counter()
    try:
        server.clientset.tpujobs().create(job)
        conds, _reasons, pods = _wait_jobs(server, [name], OPERATOR["timeout_s"])[name]
    finally:
        stop.set()
        server.shutdown()
        registry._REGISTRY.pop("chip_smoke.operator_nccl", None)
    wall = time.perf_counter() - t0
    run = runs.get("pod")
    records = run.records if run is not None else []
    backend = "gloo" if DEVICE == "cpu" else "nccl"
    want = _flash(fa, 1, 12, steps) if DEVICE != "cpu" else None
    log(f"nccl: operator {name}: {json.dumps({'conditions': conds, 'pods': [p.spec.containers[0].resources for p in pods], 'env_mesh': pods[0].spec.containers[0].env.get('TFK8S_MESH') if pods else None, 'wall_s': wall, 'losses': [h['loss'] for h in runs.get('history') or []], 'ranks': [{'device': r['device'], 'backend': r['backend'], 'peak_gib': (r['peak_memory_bytes'] or 0) / 2**30, 'launches': r['launches'].get('flash_attention')} for r in records]})}")
    if conds[-1:] != ["Succeeded"]:
        raise AssertionError(f"the h100-4 job ended {conds}")
    if [p.spec.containers[0].resources for p in pods] != [{"nvidia.com/gpu": "4"}]:
        raise AssertionError("the h100-4 job's pod does not request its four cards")
    if len(records) != 4 or {r["backend"] for r in records} != {backend}:
        raise AssertionError(f"the h100-4 pod ran {len(records)} ranks over "
                             f"{ {r['backend'] for r in records} }, want 4 over {backend}")
    if DEVICE != "cpu" and sorted(r["device"] for r in records) != [f"cuda:{i}" for i in range(4)]:
        raise AssertionError("the h100-4 pod's ranks do not take a card each")
    if want is not None and any(r["launches"]["flash_attention"] != want for r in records):
        raise AssertionError(f"the h100-4 pod's ranks launched "
                             f"{[r['launches']['flash_attention'] for r in records]}, want {want}")


GATEWAY = dict(manifest=os.path.join("manifests", "examples", "gpt-serve-h100-torch.json"),
               requests=16, concurrency=8, roll_clients=4, roll_prompt=64, roll_gen=16,
               seed=5, ready_s=120.0, roll_s=120.0, timeout_s=120.0, limit_s=75.0)
# the CPU rehearsal's template env (the card run overrides nothing)
GATEWAY_CPU_ENV = {"TFK8S_DEVICE": "cpu"}


def _serve_pods(server, name):
    """(live pods, ready pods) of TPUServe ``name``: live as the serve
    controller counts them (not deleting, not ended), ready by
    ``replica_is_ready``."""
    from tfk8s_tpu_torch.api.types import PodPhase
    from tfk8s_tpu_torch.runtime.server import replica_is_ready
    from tfk8s_tpu_torch.trainer import labels as L

    pods, _ = server.clientset.pods().list(label_selector=L.serve_selector(name))
    ended = (PodPhase.FAILED, PodPhase.SUCCEEDED, PodPhase.DRAINED)
    live = [p for p in pods if p.metadata.deletion_timestamp is None
            and p.status.phase not in ended]
    return live, [p for p in live if replica_is_ready(p)]


def _gateway_latency(results):
    """p50/p99 of the replica-reported TTFT and of the caller's wall
    latency over ``_run_each`` results."""
    import numpy as np

    ttft = np.array([r["ttft_s"] for r, _, _ in results])
    lat = np.array([t1 - t0 for _, t0, t1 in results])
    return {"ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99))}


def _in_waves(calls, width):
    """``_run_each`` over ``calls``, ``width`` at a time."""
    out = []
    for i in range(0, len(calls), width):
        out.extend(_run_each(calls[i:i + width]))
    return out


def phase_gateway(torch, kernel_modules, root):
    """The example manifest's GPT-2-small TPUServe through the port's
    serve controller and gateway: Ready, traffic over HTTP against direct
    submits, a checkpoint rollout under traffic (docstring phase 25)."""
    import threading
    import urllib.request

    import numpy as np

    from tfk8s_tpu_torch.api.types import ServeConditionType
    from tfk8s_tpu_torch.cmd.main import load_manifest
    from tfk8s_tpu_torch.cmd.options import Options
    from tfk8s_tpu_torch.cmd.server import Server
    from tfk8s_tpu_torch.gateway import GatewayClient
    from tfk8s_tpu_torch.runtime import server as serving
    from tfk8s_tpu_torch.runtime.pod_ranks import free_port
    from tfk8s_tpu_torch.trainer import labels as L

    t_phase = time.perf_counter()
    card = phase_card()
    serve = load_manifest(os.path.join(root, GATEWAY["manifest"]))
    if DEVICE == "cpu":  # the CPU rehearsal
        serve.spec.template.env.update(GATEWAY_CPU_ENV)
    name = serve.metadata.name
    gen = int(serve.spec.template.env["TFK8S_SERVE_GEN_TOKENS"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_modules:
        mod.reset_launches()
    port = free_port()
    server = Server(Options(capacity={"h100-1": 1}, gateway_port=port, workers=2))
    stop = threading.Event()
    server.run(stop, block=False)
    url = f"http://127.0.0.1:{port}"
    client = GatewayClient(url, name)
    sent, summary, failures = 0, {"card": card}, []
    try:
        # (a) Ready
        t_sub = time.perf_counter()
        server.clientset.tpuserves().create(serve)

        def available():
            st = server.clientset.tpuserves().get(name).status
            return st.ready_replicas == 2 and any(
                c.type == ServeConditionType.AVAILABLE and c.status for c in st.conditions)

        if not _wait_until(available, GATEWAY["ready_s"]):
            raise AssertionError(f"{name} was not Available with 2 ready replicas within "
                                 f"{GATEWAY['ready_s']:.0f} s")
        summary["submit_to_ready_s"] = time.perf_counter() - t_sub
        live, ready = _serve_pods(server, name)
        old_version = ready[0].metadata.labels[L.SERVE_VERSION]
        replicas = [serving.lookup_replica(p.metadata.key) for p in ready]
        summary["pods"] = [{"name": p.metadata.name,
                            "resources": p.spec.containers[0].resources,
                            "device": str(r.model.device) if r is not None else None}
                           for p, r in zip(ready, replicas)]
        if len(live) != 2 or any(r is None for r in replicas):
            raise AssertionError(f"live pods {[p.metadata.name for p in live]}, "
                                 f"registered {summary['pods']}")
        if any(p["resources"] != {"nvidia.com/gpu": "1"} for p in summary["pods"]):
            failures.append(f"replica pods request {summary['pods']}")
        want_device = "cpu" if DEVICE == "cpu" else "cuda:0"
        if any(p["device"] != want_device for p in summary["pods"]):
            failures.append(f"replica decoders on {summary['pods']}, want {want_device}")

        # (b) traffic through the wire against direct submits
        vocab = replicas[0].model.vocab_size

        def requests(seed):
            return [dict(p, tokens=[int(t) for t in p["tokens"]], gen_tokens=gen)
                    for p in _serve_requests(GATEWAY["requests"], vocab, seed=seed)]

        payloads, baseline = requests(0), requests(1)
        timeout = GATEWAY["timeout_s"]
        # a short request warms each replica's loop; then, both on prompts
        # the prefix caches have not seen, a timing baseline of direct
        # submits spread over both replicas (as the gateway spreads them)
        # and the requests through the gateway; last the same requests
        # direct, whose replies the gateway's must equal
        warm = {"tokens": list(range(1, 17)), "gen_tokens": 4}
        _results(_run_each([lambda r=r: r.submit(warm, timeout=timeout) for r in replicas]),
                 "warm-up")
        direct_runs = _in_waves([lambda i=i, p=p: replicas[i % 2].submit(p, timeout=timeout)
                                 for i, p in enumerate(baseline)], GATEWAY["concurrency"])
        _results(direct_runs, "direct")
        via = _in_waves([lambda p=p: client.request(p, timeout=timeout) for p in payloads],
                        GATEWAY["concurrency"])
        sent += len(payloads)
        via_out = _results(via, "gateway")
        direct = _results(_in_waves([lambda i=i, p=p: replicas[i % 2].submit(p, timeout=timeout)
                                     for i, p in enumerate(payloads)], GATEWAY["concurrency"]),
                          "direct")
        differ = [i for i, (a, b) in enumerate(zip(via_out, direct))
                  if a["tokens"] != b["tokens"]]
        if differ:  # the gateway may have routed those to the other replica
            other = {i: replicas[1 - i % 2].submit(payloads[i], timeout=timeout)
                     for i in differ}
            differ = [i for i in differ if other[i]["tokens"] != via_out[i]["tokens"]]
        with urllib.request.urlopen(f"{url}/debug/decode", timeout=30) as resp:
            decode_view = json.loads(resp.read())
        listed = sorted(k for k in decode_view["replicas"] if k.startswith("default/" + name))
        summary["traffic"] = {
            "requests": len(payloads), "gateway": _gateway_latency(via),
            "direct": _gateway_latency(direct_runs),
            "differ_from_direct": differ, "debug_decode_replicas": listed}
        if differ:
            failures.append(f"gateway replies {differ} differ from direct submits")
        if any(len(r["tokens"]) != gen for r in via_out):
            failures.append(f"a gateway reply did not complete {gen} tokens")
        if listed != sorted(p.metadata.key for p in ready):
            failures.append(f"/debug/decode lists {listed}")

        # (c) a rollout under closed-loop traffic
        rng = np.random.default_rng(GATEWAY["seed"])
        prompts = [[int(t) for t in rng.integers(1, vocab, GATEWAY["roll_prompt"])]
                   for _ in range(GATEWAY["roll_clients"] + 1)]
        probe = {"tokens": prompts[-1], "gen_tokens": GATEWAY["roll_gen"]}
        before = replicas[0].submit(probe, timeout=timeout)["tokens"]
        del replicas
        errors, served, hammer_stop = [], [0] * GATEWAY["roll_clients"], threading.Event()

        def hammer(i):
            mine = GatewayClient(url, name)
            try:
                while not hammer_stop.is_set():
                    try:
                        mine.request({"tokens": prompts[i], "gen_tokens": GATEWAY["roll_gen"]},
                                     timeout=timeout)
                        served[i] += 1
                    except Exception as e:  # noqa: BLE001 — any failure fails the phase
                        errors.append(repr(e))
            finally:
                mine.close()

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
                   for i in range(GATEWAY["roll_clients"])]
        for t in threads:
            t.start()
        t_roll = time.perf_counter()
        server.clientset.tpuserves().patch(name, {"spec": {"checkpoint": "seed:1"}})
        min_ready, max_live, polls = 2, 0, 0
        while True:
            live, ready = _serve_pods(server, name)
            polls += 1
            min_ready, max_live = min(min_ready, len(ready)), max(max_live, len(live))
            st = server.clientset.tpuserves().get(name).status
            if (st.observed_version not in ("", old_version) and st.ready_replicas == 2
                    and st.updated_replicas == 2
                    and all(p.metadata.labels[L.SERVE_VERSION] != old_version for p in live)):
                break
            if time.perf_counter() - t_roll > GATEWAY["roll_s"]:
                hammer_stop.set()
                raise AssertionError(f"the rollout did not end within {GATEWAY['roll_s']:.0f} s")
            time.sleep(0.01)
        roll_s = time.perf_counter() - t_roll
        hammer_stop.set()
        for t in threads:
            t.join(timeout=timeout)
        sent += sum(served) + len(errors)
        new_keys = [p.metadata.key for p in ready]
        new_replica = serving.lookup_replica(new_keys[0])
        after_direct = new_replica.submit(probe, timeout=timeout)["tokens"]
        after_gw = client.request(probe, timeout=timeout)["tokens"]
        sent += 1
        old_left = _wait_until(lambda: not [
            p for p in server.clientset.pods().list(
                label_selector=L.serve_selector(name))[0]
            if p.metadata.labels[L.SERVE_VERSION] == old_version], 30.0)
        summary["rollout"] = {
            "seconds": roll_s, "requests_served": sum(served), "failed": len(errors),
            "errors": errors[:3], "polls": polls, "min_ready": min_ready, "max_live": max_live,
            "updated": st.updated_replicas, "old_pods_deleted": old_left,
            "after_equals_direct": after_gw == after_direct,
            "after_differs_from_seed0": after_direct != before}
        if errors:
            failures.append(f"{len(errors)} requests failed during the rollout: {errors[:3]}")
        if min_ready < 2 or max_live > 3:
            failures.append(f"the rollout went to {min_ready} ready, {max_live} live")
        if not old_left:
            failures.append("the old version's pods were not deleted")
        if after_gw != after_direct:
            failures.append("after the rollout the gateway's reply differs from a new replica's")
        if after_direct == before:
            failures.append("the seed:1 replica answers as the seed:0 one did")
        if sum(served) < 1:
            failures.append("no request was served during the rollout")
    finally:
        # the serve's delete drains and stops its replicas; the kubelet's
        # stop ends no pod
        client.close()
        with contextlib.suppress(Exception):
            server.clientset.tpuserves().delete(name)
        _wait_until(lambda: not [k for k in serving.replica_keys()
                                 if k.startswith(f"default/{name}-")], 60.0)
        stop.set()
        server.shutdown()
        server.gateway.server_close()

    # (d) no kernel, every request counted
    launches = {k: v for mod in kernel_modules for k, v in mod.LAUNCHES.items()}
    counted = sum(v for k, v in server.metrics.snapshot()["counters"].items()
                  if k.startswith("tfk8s_gateway_requests_total{"))
    summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   kernel_launches=launches, gateway_requests_total=counted,
                   requests_sent=sent, phase_s=time.perf_counter() - t_phase)
    log(f"gateway: {json.dumps(summary)}")
    if any(launches.values()):
        failures.append(f"the serving path launched port kernels: {launches}")
    if counted != sent:
        failures.append(f"the gateway counted {counted} requests, {sent} were sent")
    if summary["phase_s"] > GATEWAY["limit_s"]:
        failures.append(f"the gateway phase took {summary['phase_s']:.1f} s, over its "
                        f"{GATEWAY['limit_s']:.0f} s limit")
    if failures:
        raise AssertionError("; ".join(failures))
    return {k: 0 for k in launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tfk8s_tpu_torch")):
        print("chip_smoke: the tfk8s_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description="On-card smoke test of the port.")
    ap.add_argument("--only", default="", help="comma-separated phases (development aid)")
    only = [p for p in ap.parse_args().only.split(",") if p]

    from tfk8s_tpu_torch.models import gpt, resnet
    from tfk8s_tpu_torch.ops import _build
    from tfk8s_tpu_torch.ops import block_copy as bc
    from tfk8s_tpu_torch.ops import flash_attention as fa
    from tfk8s_tpu_torch.ops import group_norm as gn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    ckpt_dir = os.path.join(root, "build", "chip_smoke_ckpt")
    rn_ckpt_dir = os.path.join(root, "build", "chip_smoke_resnet_ckpt")
    for d in (ckpt_dir, rn_ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
    failed, line, launches = [], None, {}
    card_line = None
    phases = [
        ("card", phase_card),
        ("build", lambda: phase_build(_build)),
        ("kernels", lambda: phase_kernels(fa, torch)),
        ("reference", lambda: phase_reference(torch, gpt, fa)),
        ("resnet_reference", lambda: phase_resnet_reference(torch, resnet, gn)),
        ("train", lambda: phase_train(torch, gpt, fa, ckpt_dir)),
        ("resnet_train", lambda: phase_resnet_train(torch, resnet, gn, rn_ckpt_dir)),
        ("roofline", lambda: phase_roofline(torch, bc)),
        ("generate", lambda: phase_generate(torch, gpt, fa)),
        ("serve", lambda: phase_serve(torch, gpt, (fa, gn, bc))),
        ("disagg", lambda: phase_disagg(torch, (fa, gn, bc))),
        ("distributed", lambda: phase_distributed(torch, gpt, fa, root)),
        ("families", lambda: phase_families(torch, fa)),
        ("parallel", lambda: phase_parallel(torch, gpt, fa, root)),
        ("tensor", lambda: phase_tensor(torch, fa, root)),
        ("axes", lambda: phase_axes(torch, fa, root)),
        ("nccl", lambda: phase_nccl(torch, gpt, fa, gn, root)),
        ("pipeline", lambda: phase_pipeline(torch, fa, gn, root)),
        ("pipeline_axes", lambda: phase_pipeline_axes(torch, fa, gn, root)),
        ("profile", lambda: phase_profile(torch, gpt, fa, root)),
        ("text", lambda: phase_text(torch, gpt, fa, root)),
        ("images", lambda: phase_images(torch, fa, gn, root)),
        ("pod_ranks", lambda: phase_pod_ranks(torch, fa, root)),
        ("operator", lambda: phase_operator(torch, gpt, fa, root)),
        ("gateway", lambda: phase_gateway(torch, (fa, gn, bc), root)),
    ]
    if only:
        phases = [p for p in phases if p[0] in ("card", "build", *only)]
    try:
        for name, run in phases:
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                value = run()
                torch.cuda.synchronize()
            except Exception:  # noqa: BLE001 — every phase reports, then the run fails
                traceback.print_exc()
                failed.append(name)
                if name == "build":
                    break  # nothing after it can launch a kernel
                continue
            finally:
                log(f"== {name}: {time.perf_counter() - t0:.1f} s")
            if name == "card":
                card_line = value
                log(f"card: {card_line}")
            elif name == "kernels":
                line = value
            elif name in ("train", "resnet_train", "roofline", "generate", "distributed",
                          "families", "parallel", "tensor", "axes", "pipeline",
                          "pipeline_axes", "profile", "text", "images", "pod_ranks",
                          "operator", "gateway"):
                for kernel, count in value.items():  # each path's launches add up
                    launches[kernel] = launches.get(kernel, 0) + count
    finally:
        close_gangs()  # the gloo gangs kept across phases
    for d in (ckpt_dir, rn_ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: phases {[p[0] for p in phases]} passed (no result with --only)",
              file=sys.stderr)
        return 0
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = line[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{key: r[key] for key in ("device_ms", "library_device_ms")
               if r.get(key) is not None},
        })
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
