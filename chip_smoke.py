#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:

1. build    compile every CUDA kernel from ``src/repro_torch/csrc`` with nvcc
            (one process per source, all at once) and print the build time
            and the ptxas register/spill report.
2. kernels  hold each kernel against its plain PyTorch version on the card,
            at the serving shapes, at a 2048-token context (B=8, 128 pages
            per sequence) and at qwen2-1.5b's long-context decode (q
            [4,16,128], 12 real heads over 2 KV heads, 264 pages per
            sequence, phase 6's first-wave lengths 3637/2981/2594/1853):
            and with a sliding window at phase 9's shapes (hymba-1.5b: q
            [4,32,64], 25 real heads over 5, window 1024, lengths
            700/1024/1900/2048; mixtral-8x7b: q [4,32,128] over 8, window
            4096, lengths 2000/4096/4616/4800; the bound counts only the
            visible keys, SDPA is masked to them):
            paged_attention in bf16 and fp32 within the
            JAX package's kernel-test tolerances (fp32 2e-5, bf16 3e-2) and
            each real head's output row within 1e-2 (bf16) / 2e-5 (fp32) of
            the plain row's norm; page_gather/page_scatter bitwise, on one
            layer's pool (serve: 1 and 2 pages; ctx2048: 128) and at the
            engine's call shapes (``COPY_CASES``: smollm's and qwen2's
            installs, a 4095-token one among them, and copies-on-write,
            every layer of both pools), each variant of the copy kernel and
            the parent's call pattern (a staging copy, one launch per layer)
            held and timed; the weight pager's copies (``WEIGHT_COPY_CASES``:
            one qwen2-1.5b layer of 47 2 MiB pages installed into or
            gathered from a [376, 1048576] bf16 pool), both variants held
            bitwise and timed beside index_copy_ / index_select; page ids
            outside [0, P) held to the reference's contract (wrap [-P, 0),
            fill or drop the rest) on both variants, [P, E] and layered,
            bf16 / fp32 / int32; flash_attention in bf16 and
            fp32 at smollm's prefill bucket (q [1,16,32,64], 9 real heads
            over 3 KV heads), qwen2-1.5b's 4096-token causal prompt (q
            [1,16,4096,128], 12 real heads over 2) and its 1024-token one
            (phase 7's shape), a 256-token sliding
            window, a ragged non-causal 200 x 333 case, llama3-8b's heads at
            4096 tokens (q [1,32,4096,128] over 8 KV heads), smollm's at
            2048 (D 64), and phase 9's windowed prefills (hymba-1.5b's heads
            over 1600 prompt + 128 meta tokens, window 1024; mixtral-8x7b's
            4600-token prompt, window 4096), and phase 10's (seamless-m4t's
            encoder, q [1,16,1200,64], and cross-attention, q [4,16,32,64]
            over 1200 keys, both non-causal; qwen2-vl's 1536-token prompt,
            q [1,32,1536,128], 28 of 32 heads over 4), its inputs strided views as
            the model hands them over, and besides each output row within
            1e-2 (bf16) / 2e-5
            (fp32) of the plain row's norm.  Where bf16 takes the hopper
            variant (TMA + wgmma), the generic kernel is checked and timed
            beside it.  Time kernel, plain
            version and a library yardstick in turns (CUDA events around
            device work only, L2 flushed before each launch, median of 30
            after warm-up), and the wrapper's host time per call.
3. serve    the main path: ``ServeEngine`` on full-width smollm-135m (bf16,
            random weights from a seed) at the launcher's shapes — 16
            requests of 4-24 prompt tokens x 16 new tokens, batch 8, page 16,
            512 pages, 32 pages per sequence, prefill bucket 32 — plus a
            registered 20-token prefix (not a page multiple) and a request of
            that prefix + 1 token, which forces a decode-time copy-on-write.
            Launch counts are zeroed just before and read just after; every
            kernel must have launched, the page copies at most once per pool
            for each install and copy-on-write (``LAUNCH_CAPS``), all on
            the bulk variant.  Host ms of each install.
4. check    the outputs: an fp32 full-width engine run whose greedy tokens
            must equal the port's own unbatched contiguous decode, and, for
            the bf16 run, each generated token's contiguous-decode logit
            within tolerance of the maximum logit (near-ties make bf16
            argmax flaky).
5. profile  one decode step with 8 live lanes: host wall time per step with
            and without ``torch.profiler``, device busy time, idle share,
            device ops per step, paged_attention's device time and share,
            and the costliest ops.
6. long_prompt  qwen2-1.5b at full width (28 layers, d_model 1536, 12 heads
            padded to 16 over 2 KV heads, head_dim 128, QKV bias, vocab
            151936; bf16, random weights from seed 0, nothing cut): 4
            requests of 1024-4096 prompt tokens (numpy seed 0) plus one of
            exactly 4096, x 16 new tokens, batch 4, page 16, 1408 pages, 264
            pages per sequence, prefill bucket 32; the 4096-token request's
            first 4095 tokens are registered as a shared prefix, so its first
            decode write copies a shared page.  Launch counts zeroed just
            before and read just after; all four kernels must have launched,
            every flash_attention launch must have taken the hopper
            variant, and the page copies are held as in phase 3.
            Prefill ms per request (the engine's device time between CUDA
            events), decode tok/s, peak device memory (only the bf16
            weights on the card), one profiled 4096-token prefill
            (device busy, flash_attention's device ms and share, costliest
            ops), and a profile of the decode step
            with the first wave's 4 requests live at 1.8-3.6 k contexts (as
            phase 5, on a fresh engine).  Checks: drained with no expiry
            and no leaked page, tokens in the vocabulary, an fp32 engine run
            of one 1100-token request x 8 tokens (run first, before the
            weights are cast to bf16) equal to unbatched contiguous decode
            whose prefill takes explicit positions (the plain attention
            route), and the bf16 tokens of the shortest request within
            tolerance of that decode's maximum logit.
7. weight_pager  full-width qwen2-1.5b's 28 decoder layers (phase 6's bf16
            weights, nothing cut) streamed from host memory: each layer's
            weights flattened into one bf16 image of ~48.4 M elements, packed
            by ``pack_layer_arrays`` at 2 MiB pages (47 a layer, 2.76 GB)
            into a ``HostArrayStore``, mounted with a 256 MiB page buffer;
            a ``RegionLayerSource`` with a device pool of 8 layers (376
            pages) and a ``LayerWeightPager`` (4 slots, readahead 2, 2
            fillers on their own streams) over it.  A 1024-token prompt
            (numpy seed 0) is embedded and run through ``block_apply``
            (prefill, flash_attention) layer by layer, then the final norm:
            two passes, then a profiled one.  Launch counts zeroed just
            before the two passes and read just after.  Checks: each pass's
            last hidden state bitwise equal to ``transformer.prefill`` on
            the resident weights, and the first pass's within 5e-2 (the
            norm of the difference over the norm) of a resident prefill
            with explicit positions, which takes the plain attention route
            and not the kernel; no staging copy; the region's leases a
            whole number of layers, each fetched layer one page_scatter,
            each layer read one page_gather, all bulk; every
            flash_attention launch hopper.  Prints ms per pass, H2D GB/s, the pager's
            counters, the profiled pass's device busy ms, H2D ms and idle
            share, peak memory, and the resident prefill's ms.
8. train    full-width smollm-135m training (30 layers, d_model 576, 9
            heads padded to 16 over 3, d_ff 1536, vocab 49152; fp32
            parameters, bf16 compute, remat "full", attention chunks of 512;
            weights from seed 0) at batch 4 x 2048 tokens, so every layer's
            attention takes the chunked flash-VJP path.  (1) The training
            attention (``FlashVJPAttention``) at those heads and length,
            bf16 and fp32, against autograd through the plain dense
            attention: output within 1e-2 / 2e-5 per row, dq, dk, dv within
            1e-1 / 2e-5 per row floored at the median row norm and 1e-2 /
            2e-5 over the tensor (``TRAIN_GRAD_ROW_TOL``: why bf16 rows need
            more); forward + backward timed beside the dense route and
            SDPA's.  (2) The
            resident ``Trainer`` as ``launch/train.py`` builds it, fed by
            ``data/pipeline.lm_batches`` from a synthetic shard under
            ``build/``: 4 steps, every loss finite and the first within 0.5
            of ln 49152; step ms, tok/s, peak memory, the idle share of the
            profiled 4th step.  (3) ``OOCTrainer`` resident then paged for 3
            steps from the same weights and batches: 1 MiB pages, ~3x
            oversubscription (buffers sized as the reference's tests size
            them), a device pool holding every parameter page.  Launch
            counts zeroed just before the paged steps and read just after.
            Checks: paged and resident state_dicts and losses bitwise equal,
            no staging copy, one bulk page_scatter per leaf fetched and one
            bulk page_gather per leaf read.  Prints each mode's step s and
            their ratio, the sweep's pages and chunks, its host<->device
            copy time, the grad phase's leaf fetch (bytes, s), and a
            profiled 4th paged step's idle share.  A watchdog ends the run
            with every thread's stack if the out-of-core part hangs.  (4) A
            fresh ``Trainer`` on the same 3 batches: losses within 1e-4
            relative of the paged ``OOCTrainer``'s, parameters within 1e-4
            of their norm.
9. zoo      the MoE and hybrid decoders, and the dense models run so far
            only as kernel shapes, served through ``ServeEngine`` at full
            width (``ZOO``; bf16, random weights from seed 0 made on the
            card): hymba-1.5b (16 of 32 layers, d_model 1600, 25 heads
            padded to 32 over 5, D 64, 128 meta tokens, window 1024 but on
            layer 0, Mamba heads of d_inner 3200), mixtral-8x7b (4 of
            32 layers: 8 experts top-2, window 4096), phi3.5-moe (4 of 32
            layers: 16 experts top-2), llama3-8b and deepseek-7b (16 of 32,
            15 of 30 layers; cut in PR 26 for time).  Each: an fp32 check
            first where ``ZOO`` has one (hymba-1.5b at its 16 layers, 1300
            tokens; mixtral-8x7b at 2 layers, 4200
            tokens, past its window; one lane, bucket 1, x 8 new): greedy
            tokens equal to the port's unbatched contiguous decode, whose
            positions count the meta tokens.  Then the bf16 traffic, 4-8
            prompts of 64-4600 tokens x 16 new, batch 4, page 16, plus a
            registered prefix and a request of it + 1 token (a decode
            copy-on-write), with the launch counts zeroed just before and
            read just after: every kernel launched, paged_attention with the
            window where the model has one (and without it on hymba's global
            layers), every flash_attention launch hopper, the page copies
            bulk, at most one launch per pool of each attention segment for
            each install and copy-on-write (``LAUNCH_CAPS``); drained, no
            expiry, no leaked page, tokens in the vocabulary.  Prints
            prefill ms per request,
            decode tok/s, peak memory, the MoE models' dropped share of
            expert assignments, a profiled decode step with 4 live lanes
            (for MoE also the expert FFNs' and the dispatch's device ms), for
            hymba a profiled 1899-token prefill with the selective scan's
            device ms and share, and, where ``ZOO`` says so, the bf16 tokens
            of the shortest request within tolerance of a teacher-forced
            contiguous decode's maximum logit.  Each model is freed before
            the next.
10. zoo_rest the rest of the zoo at full width (bf16, random weights from
            seed 0 made on the card), each freed before the next, every
            count zeroed just before its traffic and read just after.
            xlstm-1.3b (d_model 2048, 4 heads; its 48 blocks are 6 units of
            7 mLSTM + 1 sLSTM, served at 16: 2 units) through
            ``ServeEngine``: first the fp32 check at 8 of 48 blocks (block
            7 the first sLSTM), one lane, a 600-token prompt x 8 new, engine
            tokens equal to contiguous prefill + decode; then 4 prompts of
            256/700/1300/2048 tokens x 16 new, batch 4 (no kernel of the
            port on its path: none may launch), the bf16 tokens of the
            shortest within tolerance of a teacher-forced contiguous
            decode's maximum logit, a profiled decode step with 4 lanes and
            a profiled 1300-token prefill with the sLSTM loop's and the
            mLSTM chunk scan's device ms (on the first 8 blocks, the unit
            the 48 repeat).
            qwen2-vl-7b (28 layers, d_model 3584, 28 heads padded to 32
            over 4, D 128, M-RoPE 16/24/24) through ``prefill`` on 1536
            patch embeddings then ``decode_step`` on text tokens, batch 1:
            positions whose three rows are the index (the kernel route) and
            256 text + a 32 x 32 image block + 256 text (the plain route),
            each x 16 greedy tokens; the first decode step's logits against
            ``forward_train`` over prompt + token, in fp32 at 2 of 28 layers
            (rtol 2e-3 / atol 2e-4, ``tests/test_extras.py``) and in bf16
            at full width (its argmax within 3e-2 of the full forward's top
            logit, as phase 9's bf16 check; the row's error printed);
            one prefill on each route, its 28 ``flash_attention`` launches
            all hopper.  seamless-m4t-medium (12 + 12 layers, d_model 1024,
            16 heads, GELU d_ff 4096, vocab 256206): batch 4 of 1200 frames
            with 32-token decoder prompts and one request of 400 frames
            alone, x 32 new; the fp32 check at full width (first decode
            step against ``forward_train``, rtol 2e-3 / atol 2e-4), each
            bf16 token within tolerance of a teacher-forced
            ``forward_train``'s top logit, 36 ``flash_attention`` launches a
            prefill (encoder and cross non-causal, decoder causal), all
            hopper.  Prints prefill (and encode) ms, decode tok/s, peak
            memory and the counts.
11. distributed  the distribution slice under NCCL at world size 1 (a
            file store under build/, a (1, 1) ("data", "model")
            DeviceMesh; no gloo, no fallback), printing the NCCL version:
            (a) the dry run of all 33 cells x 2 production meshes, rank
            0's program executed on meta under a fake process group of the
            mesh (``DIST_DRY_*``: in niced children started right after
            phase 2, collected here), every record ok, each record's
            per-device peak bytes, flops, collective bytes, ``fits`` and
            meta seconds, the sweep's seconds and how many fit the card by
            their peak; (b) the data-parallel ZeRO-1 train cell, full-width
            smollm-135m from phase 8's weights and batches (4 x 2048, 3
            steps), params, m and v bitwise ``train_step``'s after every
            step, step ms in turns with it; (c) ``compressed_all_reduce``
            on that gradient tree beside an fp32 all_reduce, ms and bytes;
            (d) shard-local MoE, TP at mixtral-8x7b's widths and EP at
            phi3.5-moe's on 4 x 512 tokens, fp32 within 1e-5 and bf16
            within 3e-2 (row norm) of the dense dispatch, both timed; (e)
            phase 8's paged state through a ``HostArrayStore`` and
            ``restore_train_state_elastic`` onto the mesh, one batched
            read, local shards bitwise equal; (f) qwen2-1.5b's prefill cell
            at 4 x 1024, logits bitwise ``T.prefill``'s, its 28
            flash_attention launches all hopper.  The card's peak of (b)'s
            last cell call and of (f)'s (after a garbage collection, the
            rise of ``max_memory_allocated`` plus the arguments) within 10 %
            of the dry run's meta run of the same cell at (1, 1), the
            ratio printed either way.
12. tensor_parallel  tensor parallelism over ``model`` (``TP_*``): (a)
            flash_attention on one rank's heads (``head_offset``), bf16 at
            full width: llama3-8b's 32 heads over 4 ranks (q [1,8,4096,128],
            offsets 0/8/16/24) and qwen2-1.5b's 16 padded heads over 2
            (offset 8: 4 real heads, 4 padded); every shard on both variants
            bitwise those heads of the launch over every head and held to
            its plain version as phase 2 holds it; the offset-8 shard timed
            as phase 2 times, beside the full launch.  (b) The TP code path
            under NCCL at world size 1 (``make_host_mesh(model=1)``):
            full-width qwen2-1.5b's prefill cell at 4 x 1024 (phase 11's
            weights and tokens; counts zeroed just before and read after
            the decode) and 8 steps of its decode cell; the logits bitwise
            phase 11 (f)'s, the greedy tokens (and logits) those of
            ``T.prefill`` + ``T.decode_step``, 28 launches all hopper at
            head offset 0.  (c) The same cells over 2 gloo ranks (spawned
            processes, a file store under build/) sharing the one card, a
            (1, 2) mesh: every rank on its shards (heads, KV heads, ffn and
            vocab split; the decode cache split by sequence), fed (b)'s
            tokens; logits within 3e-2 (row norm) of (b)'s, each greedy
            token within 3e-2 of (b)'s top logit, each rank's 28 launches
            hopper at its own head offset (0, 8).  (c)'s times are gloo's,
            which stages every collective through the host.
13. tensor_parallel_train  the train cell tensor-parallel over ``model``
            (``TPT_*``): full-width qwen2-1.5b (12 heads padded to 16 over 2
            KV heads, D 128, tied vocab 151936; fp32 params, bf16 compute,
            remat "full") at 14 of its 28 layers (two whole training states
            must fit the card in (a)), random weights from seed 0 made on
            the card, batch 1 x 2048 of numpy seed 0 tokens, 3 AdamW steps.
            (a) In a process of its own, under NCCL at world size 1
            (``make_host_mesh(model=1)``): the cell and ``train_step`` a
            step each in turns, params, m and v bitwise equal after every
            step, step ms of both, peak memory.
            (b) The same cell over 2 gloo ranks (spawned processes, a file
            store under build/) sharing the one card, a (1, 2) mesh: heads
            8 + 8 (rank 1: 4 real, 4 padded), one KV head a rank, ffn and
            vocab split, from (a)'s weights and batches: each step's loss
            within 1e-2 (relative) of (a)'s, the grad norm within 2e-2, each
            rank's m after step 1 within 5e-2 of (a)'s slice at that rank
            (per leaf, relative to its norm), the replicated leaves (the
            norms, their moments) bitwise equal across the ranks; step ms,
            the collectives a step (calls and bytes, over groups of more
            than one rank) and the peak memory of each rank.  Counts zeroed
            just before the steps and read just after: no kernel of the
            port launches in training, flash_attention (no backward kernel)
            included.  (b)'s times are gloo's, staged through the host.
            The card's peak of the last cell call, in (a) and on each rank
            of (b), within 10 % of the dry run's meta run of the cell at
            (1, 1) / (1, 2), as in phase 11.
14. tensor_parallel_zoo  the MoE and hymba cells tensor-parallel over
            ``model`` (``TPZ_*``): first ``flash_attention`` on rank 1's
            heads at (b)'s prefill shapes, as 12 (a).  Then, weights from
            seed 0 made on the card: mixtral-8x7b (2 of 32 layers, TP-MoE,
            1 x 4608 past its 4096 window), phi3.5-moe (2 of 32, EP at
            capacity 8.0, 4 x 1024), hymba-1.5b (4 of 32 layers, global
            layer 0 and 3 windowed ones, 4 x 1024 behind 128 meta tokens)
            through the prefill cell and 16 decode-cell steps,
            and their train cells (1 / 1 / 4 layers, 1 x 2048, 2 AdamW
            steps; phi3.5-moe without its per-slice load-balance loss).
            (a) In a process of its own under NCCL at world size 1: the
            cells bitwise ``T.prefill`` / ``T.decode_step`` and (under
            deterministic algorithms) ``train_step``, then in fp32 on the
            same weights and tokens.  (b) Over 2 gloo ranks sharing the
            card, fed (a)'s tokens: fp32 logits within 1e-3 (row norm) and
            m after step 1 within 1e-3 (per leaf) of (a)'s; bf16 logits
            within 3e-2 or twice (a)'s own bf16 error, fed tokens within
            3e-2 of (a)'s top logit, losses 1e-2, grad norms 2e-2, m after
            step 1 5e-2 or twice (a)'s own bf16 error; rows routed to other
            experts than (a)'s reported, not held; replicated leaves
            bitwise across the ranks; every prefill's flash_attention
            hopper at the rank's head offset.  phi3.5-moe's prefill at its
            published capacity 1.25 is reported (dropped share a rank,
            logits distance), not held.
15. tensor_parallel_rest  the xLSTM, qwen2-vl and seamless cells
            tensor-parallel over ``model``, and a decode cache split by KV
            heads (``TPR_*``): first ``flash_attention`` on rank 1's heads
            at (b)'s prefill shapes, non-causal and Sq != Sk among them.
            Then, as 14: xlstm-1.3b (8 of 48 blocks, 1 x 1024: the mLSTM's
            channels and the sLSTM's FFN split), qwen2-vl-7b (8 of 28
            layers, a 1536-token prompt on the kernel route; its image-block
            prompt, prefill only, on the plain one), seamless-m4t-medium
            (whole, 4 x 32-token prompts over 1200 frames: the encoder's
            and cross-attention's heads split, the memory KV by KV heads)
            and qwen2-1.5b (whole, 4 x 1024, its cache one position longer
            so 2 does not divide it: the decode cache split by its 2 KV
            heads) through the prefill cell and 16 decode-cell steps, and
            the train cells of the first three (8 blocks 1 x 512, 1 layer
            1 x 2048, whole 1 x 1024).  (a) NCCL at world size 1, bitwise;
            (b) 2 gloo ranks, held as 14's (no routes); (a) and (b) run in
            the processes of 14's, after its parts (one start-up each; a
            phase's ``seconds`` counts its parts, not the start-ups); every
            prefill's
            flash_attention launches hopper at the rank's head offset,
            the prefills counted by route, the decode cache's split read
            from the cell's specs.
16. examples_dp_moe  (a) the JAX package's example scripts, ported
            (``repro_torch.examples``), in this process through their
            ``main``: ``serve_paged`` at its own defaults (the smollm smoke
            config, 12 requests; its own check that the engine's tokens are
            unbatched contiguous decode's), ``train_smollm --full``
            (smollm-135m, 30 layers at d 576, ``EX_TRAIN_STEPS`` steps of 8 x
            64; its own check that the loss falls), ``quickstart`` and
            ``out_of_core_sort`` at ``EX_SORT_MB`` (host only: its speed-up
            is the host's, printed beside the host's CPU); each one's
            kernel launches counted.  (b) The shard-local MoE under
            ``parallelism="dp"`` over 2 gloo ranks sharing the card, in a
            spawn of their own: mixtral-8x7b (TP-MoE) and
            phi3.5-moe (EP, capacity 8.0) on 14's serve and train configs,
            every weight whole on every rank and each rank taking its
            expert shard, the train cell one step, donating its arguments
            (each rank holds the whole training state); held to 14's (a),
            where "dp" and "tp" run the same program, with 14's limits;
            each cell's ms, collectives a step and peak memory a rank.

Then a ``{"kernels": [...]}`` line (per kernel: launches on the main path,
max error, kernel/plain/library times, and the bound: bytes moved over
3.35 TB/s or operations over the peak rate, whichever is larger; for
flash_attention also the variant taken and each variant's time; for the
page copies the parent call pattern's time and the launches by variant;
phase 9's and phase 10's launches by model, and for paged_attention and
flash_attention its phase-2 cases at phase 9's and phase 10's shapes with the
launches of the model each stands for; for flash_attention also phase 10's
launches by variant and by mask and the prefills that took the plain
route, and phase 12 (a)'s, phase 14's and phase 15's cases with (c)'s and
(b)'s launches; phase 13's launches, zero; phases 14's, 15's and 16's by
model, and 16's by example),
the card's
name and power limit from nvidia-smi, and, last, the ``{"ok": true, ...}``
line.  Any failed check raises before that line (non-zero exit).  Without a
CUDA card, or without the rest of the repository beside it, it exits
non-zero without a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
SPIN_CYCLES = 10_000_000            # >= 5 ms at the H100's <= 1.98 GHz clock
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# attention rows: ||out - ref|| / ||ref|| over D, per (b, head[, q row]).  A
# row that averages thousands of keys (long contexts, late rows of a causal
# prompt) has |o| ~ 0.03, so TOL alone would pass tens of percent of error.
ROW_REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:74",
    "page_gather": "src/repro/kernels/page_gather/kernel.py:29",
    "page_scatter": "src/repro/kernels/page_gather/kernel.py:49",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:84",
}
SOURCES = {
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "page_gather": "src/repro_torch/csrc/page_gather.cu",
    "page_scatter": "src/repro_torch/csrc/page_gather.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
# the engine's page copies at their call shapes (bf16, page 16, both pools):
# layers, KVH, D, pool pages, and what is copied — an install of `tokens`
# prefilled positions (zeros past them in the last page), a copy-on-write
# of one page, or a copy-on-write's gathers alone
COPY_CASES = {
    "smollm_install": dict(layers=30, kvh=3, d=64, pages=512, kind="install", tokens=20),
    "smollm_cow": dict(layers=30, kvh=3, d=64, pages=512, kind="cow"),
    "smollm_cow_gather": dict(layers=30, kvh=3, d=64, pages=512, kind="gather"),
    "qwen2_install_4095": dict(layers=28, kvh=2, d=128, pages=1408, kind="install",
                               tokens=4095),
    "qwen2_cow": dict(layers=28, kvh=2, d=128, pages=1408, kind="cow"),
}
# the kernels line's page-copy numbers: the serve path's call of each
COPY_MAIN_CASE = {"page_gather": "smollm_cow_gather", "page_scatter": "smollm_install"}
# page-copy launches allowed on each path: one per pool for each install
# and copy-on-write (serve: 17 prefills + a prefix + a copy-on-write;
# long prompt: 5 prefills, one fully shared, + a prefix + a copy-on-write)
LAUNCH_CAPS = {"serve": {"page_scatter": 38, "page_gather": 2},
               "long_prompt": {"page_scatter": 12, "page_gather": 2},
               # phase 9, hymba: 9 prefills + a prefix + a copy-on-write,
               # each into the pools of its 5 attention segments (the
               # global layers 0, 16, 31 split the stack)
               "zoo": {"page_scatter": 110, "page_gather": 10}}
# the weight pager's copies (phase 7's shapes): one qwen2-1.5b layer of 47
# 2 MiB bf16 pages into / out of a device pool of 8 layers
WEIGHT_COPY_CASES = {"qwen2_weight_install": "page_scatter",
                     "qwen2_weight_gather": "page_gather"}
WEIGHT_LAYER_PAGES = 47
WEIGHT_PAGE_BYTES = 2 << 20
WEIGHT_POOL_LAYERS = 8
WEIGHT_POOL = (WEIGHT_POOL_LAYERS * WEIGHT_LAYER_PAGES, WEIGHT_PAGE_BYTES // 2)  # bf16
WEIGHT_BUFFER_BYTES = 256 << 20        # the region's page buffer
WEIGHT_PROMPT = 1024
# the weight-paged prefill's last hidden state against the plain attention
# route's: bf16 through 28 layers, norm of the difference over the norm
WEIGHT_PLAIN_REL_TOL = 5e-2
# phase 8: full-width smollm-135m training, batch 4 x 2048 (every layer's
# attention on the chunked flash-VJP path: 2048^2 > 1024^2), its padded 16
# query heads over KV expanded to them, head_dim 64, chunks of 512
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_HEADS, TRAIN_HEAD_DIM, TRAIN_ATTN_CHUNK = 16, 64, 512
TRAIN_STEPS = 4                        # the launcher's Trainer; the last profiled
OOC_STEPS = 3                          # OOCTrainer, paged and resident
OOC_PAGE = 1 << 20
OOC_OVERSUB = 3                        # state bytes over page-buffer bytes
OOC_WATCHDOG_S = 400
# the training attention's dq, dk, dv against autograd through the dense
# route: per row floored at the median row norm (grad_row_rel_err), and
# over the whole tensor (||got - want|| / ||want||).  In bf16 the flash
# backward's D = rowsum(do * o) uses the saved bf16 o, as the JAX package's
# does, and the first causal rows' dq (2-8 keys) cancel: a row there is
# 1.8e-2 off at [1, 2048, 4, 64] on the CPU and 5.3e-2 at [4, 2048, 16, 64]
# on the H100, where the dense route's own bf16 dq is 2.3e-3 from the fp32
# gradient.  So bf16 rows are held at 1e-1 and the whole tensor at 1e-2.
# Outputs keep ROW_REL_TOL.
TRAIN_GRAD_ROW_TOL = {"float32": 2e-5, "bfloat16": 1e-1}
TRAIN_GRAD_TENSOR_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# Trainer against OOCTrainer: whole-tree and decomposed AdamW may round apart
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_PARAM_REL_TOL = 1e-4
# phase 9: the MoE and hybrid decoders, and the dense ones run so far only as
# kernel shapes, served at full width (bf16, random weights from seed 0 made
# on the card).  Per model: decoder layers kept (None: all), the traffic's
# prompt lengths (numpy seed 0 tokens; x ZOO_NEW_TOKENS, batch 4, page 16,
# prefill bucket 32), the registered prefix (a request of it + 1 token
# copies a shared page on its first decode write), the pool, the fp32 check
# (layers kept, prompt tokens; x 8 new), and whether the bf16 tokens are held
# to contiguous decode's top logit (not an MoE model's: expert capacity
# depends on how many tokens share a dispatch, so batched serving may
# legitimately route otherwise than unbatched decode)
ZOO = {
    # 16 of 32 layers, d 1600, 25 heads padded to 32 over 5, D 64, 128 meta
    # tokens, window 1024 but on layer 0 (and 16, 31 past the cut): prompts
    # past 896 tokens bind it
    "hymba-1.5b": dict(layers=16, lens=[64, 420, 800, 960, 1150, 1400, 1650, 1900],
                       prefix=500, pages=1280, pps=136, fp32=(None, 1300), bf16_check=True),
    # 4 of 32 layers (2.90 GB a layer in bf16), 8 experts top-2, window 4096
    "mixtral-8x7b": dict(layers=4, lens=[4600, 300, 900, 1500, 2200, 3000], prefix=300,
                         pages=1600, pps=300, fp32=(2, 4200), bf16_check=False),
    # 4 of 32 layers, 16 experts top-2, no window
    "phi3.5-moe-42b-a6.6b": dict(layers=4, lens=[600, 1100, 1500, 2000], prefix=300,
                                 pages=700, pps=136, fp32=None, bf16_check=False),
    # the dense models, half their layers (16 of 32, 15 of 30)
    "llama3-8b": dict(layers=16, lens=[1024, 1400, 1700, 2048], prefix=300, pages=700,
                      pps=136, fp32=None, bf16_check=True),
    "deepseek-7b": dict(layers=15, lens=[1100, 1300, 1600, 2000], prefix=300, pages=700,
                        pps=136, fp32=None, bf16_check=True),
}
ZOO_NEW_TOKENS = 16
# flash_attention cases: (B, H, real heads, KVH, Sq, Sk, D, causal, window)
FLASH_CASES = {
    "smollm_prefill": (1, 16, 9, 3, 32, 32, 64, True, None),
    "qwen2_4096": (1, 16, 12, 2, 4096, 4096, 128, True, None),
    "qwen2_1024": (1, 16, 12, 2, 1024, 1024, 128, True, None),
    "window256": (1, 16, 12, 2, 4096, 4096, 128, True, 256),
    "ragged_200x333": (2, 16, 12, 2, 200, 333, 128, False, None),
    "llama3_4096": (1, 32, 32, 8, 4096, 4096, 128, True, None),
    "smollm_2048": (1, 16, 9, 3, 2048, 2048, 64, True, None),
    # phase 9's windowed prefills: hymba-1.5b's heads (25 of 32 over 5, D 64)
    # over 1600 prompt tokens + 128 meta tokens, window 1024; mixtral-8x7b's
    # 4600-token prompt, window 4096
    "hymba_1728_w1024": (1, 32, 25, 5, 1728, 1728, 64, True, 1024),
    "mixtral_4600_w4096": (1, 32, 32, 8, 4600, 4600, 128, True, 4096),
}
FLASH_CASES.update({
    # phase 10's prefills: seamless-m4t's encoder over 1200 frames and its
    # decoder's cross-attention (batch 4, 32-token prompts, MHA, D 64), both
    # without a mask; qwen2-vl's 1536-token prompt (28 of 32 heads over 4)
    "seamless_enc_1200": (1, 16, 16, 16, 1200, 1200, 64, False, None),
    "seamless_cross_32x1200": (4, 16, 16, 16, 32, 1200, 64, False, None),
    "qwen2vl_1536": (1, 32, 28, 4, 1536, 1536, 128, True, None),
})
# the phase-2 cases at phase 9's and phase 10's shapes, and the model whose
# run they stand for
ZOO_PAGED_CASES = {"hymba_window": "hymba-1.5b", "mixtral_window": "mixtral-8x7b"}
ZOO_FLASH_CASES = {"hymba_1728_w1024": "hymba-1.5b", "mixtral_4600_w4096": "mixtral-8x7b",
                   "seamless_enc_1200": "seamless-m4t-medium",
                   "seamless_cross_32x1200": "seamless-m4t-medium",
                   "qwen2vl_1536": "qwen2-vl-7b"}
# phase 11: the distribution slice at world size 1 under NCCL: the dry run's
# 33 cells x 2 production meshes, the MoE widths of mixtral-8x7b (TP) and
# phi3.5-moe (EP) on 4 x 512 tokens, qwen2-1.5b's prefill cell at 4 x 1024
DIST_DRY_RECORDS = 66
# the dry run executes each record's rank-0 program on meta (a fake process
# group of the production mesh) in this many niced children, started after
# phase 2 and collected in phase 11; the card's peak of a cell call is held
# within DIST_PEAK_REL_TOL of the meta run of the same cell and mesh
DIST_DRY_WORKERS = 4
DIST_DRY_NICE = 10
DIST_PEAK_REL_TOL = 0.10
DIST_MOE_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
DIST_MOE_TOKENS = (4, 512)
DIST_PREFILL = (4, 1024)
# phase 12: tensor parallelism over "model".  (a) flash_attention on one
# rank's heads at full width, bf16: (B, H, real heads, KVH, S, D, ranks, the
# head offset timed) — llama3-8b's 32 heads over 4 ranks (whole KV groups),
# qwen2-1.5b's 16 padded heads over 2 (rank 1: heads 8-11 real, 12-15
# padded).  (b) / (c): qwen2-1.5b's prefill cell at 4 x 1024, then
# TP_DECODE_STEPS decode-cell steps (16 until PR 26 cut them for time);
# (c) over 2 gloo ranks on the one card, its logits held
# to (b)'s per row (bf16 compute: the ranks' partial products summed in fp32
# round otherwise than one product)
TP_FLASH_CASES = {
    "llama3_4096_tp4": (1, 32, 32, 8, 4096, 128, 4, 8, None),
    "qwen2_4096_tp2": (1, 16, 12, 2, 4096, 128, 2, 8, None),
}
TP_PREFILL = DIST_PREFILL
TP_DECODE_STEPS = 8
TP_RANKS = 2
TP_LOGITS_ROW_TOL = 3e-2
# phase 13: the train cell tensor-parallel over "model": full-width
# qwen2-1.5b (12 heads padded to 16 over 2 KV heads, D 128, d_ff 8960, tied
# vocab 151936; fp32 params, bf16 compute, remat "full", attention chunks
# of 512) at 14 of its 28 layers, batch 1 x 2048 (numpy seed 0 tokens), 3
# AdamW steps.  The bytes: 14 layers x 48.4 M + the 233.4 M embedding =
# 0.911 G parameters, 3.64 GB in fp32 and 7.29 GB of moments.  (a) holds
# the cell's state and train_step's (21.9 GB) and train_step's update
# transients (gradients, clipped copies, new moments and params: ~18 GB),
# the activations under remat (14 layer inputs of 6.3 MB in bf16, one
# layer's recompute ~0.3 GB, the loss's fp32 logits of 2 chunks x 1024 x
# 151936 kept for the backward, 1.24 GB, and their temporaries): ~45 GB of
# the 80; all 28 layers would need ~80 GB.  (b) each of 2 ranks about half
# the state (the norms whole) and its half of the vocabulary's logits:
# ~13 GB a rank.  Held: (b)'s losses within 1e-2 (relative) of (a)'s, its
# grad norms within 2e-2, each rank's m shard after step 1 within 5e-2 of
# (a)'s slice at that rank (relative to the norm, per leaf): bf16 compute,
# the ranks' partial products summed in fp32
TPT_LAYERS = 14
TPT_BATCH, TPT_SEQ = 1, 2048
TPT_STEPS = 3
TPT_RANKS = 2
TPT_LR = 3e-4
TPT_LOSS_REL_TOL = 1e-2
TPT_GNORM_REL_TOL = 2e-2
TPT_M_REL_TOL = 5e-2
# phase 14: the MoE and hymba cells tensor-parallel over "model", full
# width, random weights from seed 0 made on the card, bf16 compute.  Serve
# (bf16 params): (layers kept, batch, prompt tokens), the prefill cell, then
# TPZ_DECODE_STEPS decode-cell steps; prompts long enough for every window
# to bite (hymba's 128 meta tokens take 1024 past its 1024 window; mixtral's
# 4608 past its 4096).  Train (fp32 params, remat "full"): (layers, batch,
# seq), TPZ_TRAIN_STEPS AdamW steps.  (a) under NCCL at world size 1, in a
# process of its own: the cells bitwise T.prefill / T.decode_step and
# train_step; (b) over TPZ_RANKS gloo ranks sharing the card, held to (a)
# with phase 12's and 13's limits, or twice (a)'s own bf16 error where
# larger (mixtral's MoE layers, hymba's of three sums each: a bf16 partial
# sum rounds otherwise than one product).  The serve depths (mixtral 2 of
# 32 layers, phi3.5-moe 2, hymba 4) are cut to keep the script's time with
# phases 15 and 16 in it; phase 16's dp cells are held to this (a).
# phi3.5-moe (EP) is held at a capacity
# factor that drops nothing (E / K = 8.0): capacity is per dispatch shard,
# so at its published factor 2 ranks drop other assignments than one does,
# by design; the published factor's prefill runs too, reported unheld.  So
# is its load-balance loss (a product of two means over each slice's
# tokens): its train cells are held without it (the z-loss, a plain mean,
# stays).
TPZ_SERVE = {
    "mixtral-8x7b": (2, 1, 4608),
    "phi3.5-moe-42b-a6.6b": (2, 4, 1024),
    "hymba-1.5b": (4, 4, 1024),
}
TPZ_TRAIN = {
    "mixtral-8x7b": (1, 1, 2048),
    "phi3.5-moe-42b-a6.6b": (1, 1, 2048),
    "hymba-1.5b": (4, 1, 2048),
}
TPZ_NODROP_CF = {"phi3.5-moe-42b-a6.6b": 8.0}
TPZ_DECODE_STEPS = 16
# (b) against (a) computing in fp32 (the same weights and fed tokens, the
# prefill and TPZ_FP32_STEPS decode steps): the tensor-parallel arithmetic
# alone, partial sums in another order
TPZ_FP32_ROW_TOL = 1e-3
TPZ_FP32_M_TOL = 1e-3
TPZ_FP32_STEPS = 4
# flash_attention on (b)'s rank 1 at phase 14's prefill shapes, as
# TP_FLASH_CASES (the last entry the window): mixtral's 16 of 32 heads from
# 16, hymba's 16 of its 32 padded from 16 (heads 16-24 real, 7 padded) on a
# local layer of 1024 + 128 meta tokens, phi3.5-moe's 16 from 16
TPZ_FLASH_CASES = {
    "mixtral_4608_w4096_tp2": (1, 32, 32, 8, 4608, 128, 2, 16, 4096),
    "hymba_1152_w1024_tp2": (4, 32, 25, 5, 1152, 64, 2, 16, 1024),
    "phi35moe_1024_tp2": (4, 32, 32, 8, 1024, 128, 2, 16, None),
}
TPZ_FLASH_ARCH = {"mixtral_4608_w4096_tp2": "mixtral-8x7b",
                  "hymba_1152_w1024_tp2": "hymba-1.5b",
                  "phi35moe_1024_tp2": "phi3.5-moe-42b-a6.6b"}
TPZ_TRAIN_STEPS = 2
TPZ_RANKS = 2
TPZ_LR = 3e-4
# phase 15: the xLSTM, qwen2-vl and seamless cells tensor-parallel over
# "model", and a decode cache split by KV heads, full width, random weights
# from seed 0 made on the card, bf16 compute, held as phase 14's.  Serve
# (bf16 params): (layers kept, batch, prompt tokens), the prefill cell,
# then TPZ_DECODE_STEPS decode-cell steps: xlstm-1.3b at 8 of its 48 blocks
# (one unit of 7 mLSTM + 1 sLSTM: the mLSTM's channels and the sLSTM's FFN
# split); qwen2-vl-7b at 8 of 28 layers, its text prompt (positions the
# index: the kernel route) then, prefill only, its image-block prompt (a
# VLM_GRID x VLM_GRID block: the plain route); seamless-m4t-medium whole,
# its decoder prompts over TPR_FRAMES frames (the encoder's and the cross-
# attention's heads split, the memory KV by KV heads); qwen2-1.5b whole
# with its cache one position longer than the prompt and the steps, so 2
# does not divide it and the decode cache splits its 2 KV heads (the
# decode cell's KV-head path: rank 0's KV head serves heads 0-5 and the
# padded 12-15, rank 1's heads 6-11).  Train (fp32 params, remat "full"):
# (layers, batch, seq), seamless over seq frames, qwen2-vl on embeddings
# with an image block in its positions.
TPR_SERVE = {
    "xlstm-1.3b": (8, 1, 1024),
    "qwen2-vl-7b": (8, 1, 1536),
    "seamless-m4t-medium": (None, 4, 32),
    "qwen2-1.5b": (None, 4, 1024),
}
TPR_TRAIN = {
    "xlstm-1.3b": (8, 1, 512),
    "qwen2-vl-7b": (1, 1, 2048),
    "seamless-m4t-medium": (None, 1, 1024),
}
TPR_FRAMES = 1200
TPR_HEAD_CACHE = "qwen2-1.5b"
TPR_VLM = "qwen2-vl-7b"
# flash_attention on (b)'s rank 1 at phase 15's prefill shapes, as
# TPZ_FLASH_CASES, with (causal, Sk) where the mask is not causal over Sq =
# Sk: seamless's encoder (8 of its 16 heads from 8, non-causal over its
# 1200 frames) and cross-attention (its 32-token prompts over the 1200
# frames), qwen2-vl-7b's 1536-token prompt (16 of its 32 padded heads from
# 16: heads 16-27 real, reading 2 of its 4 KV heads)
TPR_FLASH_CASES = {
    "seamless_enc_1200_tp2": (4, 16, 16, 16, 1200, 64, 2, 8, None, False, 1200),
    "seamless_cross_32x1200_tp2": (4, 16, 16, 16, 32, 64, 2, 8, None, False, 1200),
    "qwen2vl_1536_tp2": (1, 32, 28, 4, 1536, 128, 2, 16, None),
}
TPR_FLASH_ARCH = {"seamless_enc_1200_tp2": "seamless-m4t-medium",
                  "seamless_cross_32x1200_tp2": "seamless-m4t-medium",
                  "qwen2vl_1536_tp2": "qwen2-vl-7b"}
# phase 10: the rest of the zoo at full width (bf16, random weights from
# seed 0 made on the card).  xlstm-1.3b through ServeEngine at XLSTM_LAYERS
# of its 48 blocks (2 of its 6 repeating units of 7 mLSTM + 1 sLSTM; cut
# to keep the script's time with phases 14-16 in it): its prompts x
# ZOO_NEW_TOKENS, batch 4; the repeating unit's prefill profiled over the
# XLSTM_PROFILE_PROMPT-token prompt; the fp32 check at 8 of 48 blocks
# (block 7 the first sLSTM), one lane, a 600-token prompt x 8 new.
# qwen2-vl-7b: 1536-token prompts, batch 1, x 16 text tokens; an image block
# of 32 x 32 between 256 text tokens on each side; the fp32 check at 2 of
# 28 layers.  seamless-m4t-medium: batch 4 of 1200 frames and a request of
# 400 frames alone, 32-token decoder prompts, x 32 new.
# phase 16: the JAX package's example scripts on the card (their ports,
# repro_torch.examples), then the shard-local MoE under parallelism="dp"
# over model > 1 at full width.  (a) train_smollm --full takes
# EX_TRAIN_STEPS steps (its warm-up is 20: the loss must fall past it);
# out_of_core_sort sorts EX_SORT_MB through an EX_SORT_BUFFER_MB buffer.
# (b) DPM_ARCHS on phase 14's serve and train configs under "dp", over
# TPZ_RANKS gloo ranks spawned for it alone, held to phase 14's (a):
# at world size 1 "dp" and "tp" are the same program.  The train cell takes
# DPM_TRAIN_STEPS steps donating its arguments: a rank holds the whole
# training state (mixtral's layer: 29.3 GB at its peak by the dry run's meta
# accounting, 53.6 GB without donating), and two must fit on the card.
EX_TRAIN_STEPS = 30
EX_SORT_MB, EX_SORT_BUFFER_MB = 32, 8
DPM_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
DPM_TRAIN_STEPS = 1
XLSTM_LENS = [256, 700, 1300, 2048]
XLSTM_LAYERS = 16
XLSTM_PROFILE_PROMPT = 1300
XLSTM_FP32 = (8, 600)
VLM_PROMPT, VLM_TEXT, VLM_GRID, VLM_NEW = 1536, 256, 32, 16
VLM_FP32_LAYERS = 2
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_ALONE, ENCDEC_PROMPT, ENCDEC_NEW = 4, 1200, 400, 32, 32
EXTRAS_TOL = dict(rtol=2e-3, atol=2e-4)     # tests/test_extras.py, fp32


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started (``t_s``)."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - T_START}), flush=True)


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# ------------------------------------------------------------------ timing


def time_ms(torch, fn, flush, reps: int = 30, warmup: int = 3):
    """(median device ms, median host enqueue ms) of one call.

    The L2 is flushed before each call.  A spin kernel (>= 5 ms) keeps the
    card busy while the host enqueues the call, so the events bracket device
    work only, not the Python and launch overhead between them (that is the
    host time, reported apart; every host time measured so far is far below
    the spin)."""
    for _ in range(warmup):
        fn()
    dev, host = [], []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    dev.sort()
    host.sort()
    return dev[len(dev) // 2], host[len(host) // 2]


def measure(torch, flush, kernel, plain, library, others=None) -> dict:
    """Kernel, plain-version and library-call times, in turns (kernel,
    others, plain, library, library, plain, others, kernel); each is the
    mean of its two medians.  ``others`` maps a key to another call timed
    beside the kernel (another variant of it, or the parent's call
    pattern).  ``host_ms`` is the kernel wrapper's own host time per call,
    ``<other>_host_ms`` that of each other call."""
    order = [("ms", kernel), *(others or {}).items(), ("plain_ms", plain),
             ("library_ms", library)]
    runs = {k: [] for k, _ in order}
    host = {k: [] for k, _ in order}
    for key, fn in order + order[::-1]:
        dev, h = time_ms(torch, fn, flush)
        runs[key].append(dev)
        host[key].append(h)
    out = {k: sum(v) / len(v) for k, v in runs.items()}
    out["host_ms"] = sum(host["ms"]) / 2
    for key in (others or {}):
        out[key.replace("_ms", "_host_ms")] = sum(host[key]) / 2
    return out


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2


def attention_case(torch, rng, dtype, B, H, kvh, D, P, ps, pps, lengths):
    import numpy as np

    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to("cuda", dt)
    kp = torch.from_numpy(rng.standard_normal((P, ps, kvh, D), dtype=np.float32)).to("cuda", dt)
    vp = torch.from_numpy(rng.standard_normal((P, ps, kvh, D), dtype=np.float32)).to("cuda", dt)
    # distinct pages per sequence, page 0 left as scratch
    table = np.stack([rng.choice(np.arange(1, P), size=pps, replace=False)
                      for _ in range(B)]).astype(np.int32)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def attention_cost(args, num_heads, dtype, window=None):
    """Bound of one decode call: the visible K/V rows (the last ``window``
    of each sequence, if any) and the table entries of their pages."""
    q, kp, _, table, lengths = args
    isz = q.element_size()
    _, ps, kvh, d = kp.shape
    lens = [int(x) for x in lengths.tolist()]
    lows = [max(0, n - window) if window else 0 for n in lens]
    kv_rows = sum(n - lo for n, lo in zip(lens, lows))
    pages_read = sum(-(-n // ps) - lo // ps for n, lo in zip(lens, lows) if n)
    nbytes = (q.shape[0] * num_heads * d * isz          # real query heads
              + 2 * kv_rows * kvh * d * isz              # valid K and V rows
              + pages_read * 4 + q.shape[0] * 4          # table entries, lengths
              + q.numel() * isz)                         # output
    flops = 4.0 * kv_rows * num_heads * d                # QK^T and PV
    return bound_ms(nbytes, flops, dtype)


def sdpa_yardstick(torch, args, num_heads, window=None):
    """One library call on the KV gathered beforehand (gather not timed),
    masked to each sequence's visible positions."""
    import torch.nn.functional as F

    q, kp, vp, table, lengths = args
    b, _, d = q.shape
    _, ps, kvh, _ = kp.shape
    S = table.shape[1] * ps
    k = kp[table.long()].reshape(b, S, kvh, d).transpose(1, 2).contiguous()
    v = vp[table.long()].reshape(b, S, kvh, d).transpose(1, 2).contiguous()
    qh = q[:, :num_heads, None, :].contiguous()               # [B, nh, 1, D]
    pos = torch.arange(S, device="cuda")[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos >= lengths[:, None] - window
    mask = mask[:, None, None, :]
    try:
        F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                      enable_gqa=True)
    except TypeError:                 # older torch: no enable_gqa, expand KV
        rep = num_heads // kvh
        ke, ve = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(qh, ke, ve, attn_mask=mask)


def phase_kernels(torch, flush):
    import numpy as np

    from repro_torch.kernels.page_gather.kernel import page_gather, page_scatter
    from repro_torch.kernels.page_gather.ref import page_gather_ref, page_scatter_ref
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    rng = np.random.default_rng(0)
    PS = 16
    smollm = dict(H=16, NH=9, KVH=3, D=64)         # smollm-135m attention
    serve_lens = [int(x) for x in rng.integers(4, 41, size=8)]
    cases = {
        "serve": dict(smollm, B=8, P=512, pps=32, lengths=serve_lens),
        "ctx2048": dict(smollm, B=8, P=8 * 128 + 1, pps=128, lengths=[2048] * 8),
        # qwen2-1.5b decode at phase 6's first wave (long_prompt_requests, seed 0)
        "qwen2_decode": dict(H=16, NH=12, KVH=2, D=128, B=4, P=1408, pps=264,
                             lengths=[3637, 2981, 2594, 1853]),
        # phase 9's windowed decode: hymba-1.5b (25 real heads of 32 over 5,
        # D 64, window 1024) and mixtral-8x7b (32 over 8, D 128, window
        # 4096), lengths below, at and far past the window
        "hymba_window": dict(H=32, NH=25, KVH=5, D=64, B=4, P=4 * 128 + 1, pps=128,
                             lengths=[700, 1024, 1900, 2048], window=1024),
        "mixtral_window": dict(H=32, NH=32, KVH=8, D=128, B=4, P=4 * 300 + 1, pps=300,
                               lengths=[2000, 4096, 4616, 4800], window=4096),
    }
    report = {"attention": [], "copies": []}
    serve = {}
    for case, c in cases.items():
        NH, W = c["NH"], c.get("window")
        for dtype in ("bfloat16", "float32"):
            lengths = list(c["lengths"])
            if case != "serve" and dtype == "float32":
                lengths[-1] = 0                      # length 0 -> zeros
            args = attention_case(torch, rng, dtype, c["B"], c["H"], c["KVH"], c["D"],
                                  c["P"], PS, c["pps"], lengths)
            out = paged_attention(*args, num_heads=NH, window=W)
            ref = paged_attention_ref(*args, num_heads=NH, window=W)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            tol = TOL[dtype]
            ok = bool((err <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
            check(ok, f"paged_attention {case} {dtype}: max |err| {err.max().item()}")
            if W:
                full = paged_attention_ref(*args, num_heads=NH)
                binds = [i for i, n in enumerate(lengths) if n > W]
                check(all(not torch.equal(full[i], ref[i]) for i in binds),
                      f"paged_attention {case}: the window does not bind past it")
            row_err = max_row_rel_err(out[:, :NH], ref[:, :NH], "paged_attention")
            check(row_err <= ROW_REL_TOL[dtype],
                  f"paged_attention {case} {dtype}: row relative error {row_err}")
            check(bool((out[:, NH:] == 0).all()), "padded heads must be zero")
            if 0 in lengths:
                check(bool((out[lengths.index(0)] == 0).all()), "length-0 row must be zero")
            times = measure(torch, flush, lambda: paged_attention(*args, num_heads=NH, window=W),
                            lambda: paged_attention_ref(*args, num_heads=NH, window=W),
                            sdpa_yardstick(torch, args, NH, W))
            bnd, by = attention_cost(args, NH, dtype, W)
            row = dict(case=case, dtype=dtype, q=list(args[0].shape), num_heads=NH,
                       kvh=c["KVH"], pages_per_seq=c["pps"], lengths=lengths, window=W,
                       max_abs_err=err.max().item(), max_row_rel_err=row_err, **times,
                       bound_ms=bnd, bound_by=by)
            report["attention"].append(row)
            if case == "serve" and dtype == "bfloat16":
                serve["paged_attention"] = row

    # page copies: a layer's pool viewed as [P, page_size*KVH*D] bf16;
    # serve: COW gathers 1 page, a prefill installs 2; ctx2048: 128 pages
    for case, P, n_gather, n_scatter in (("serve", 512, 1, 2), ("ctx2048", 1025, 128, 128)):
        E = PS * smollm["KVH"] * smollm["D"]
        pool = torch.from_numpy(rng.standard_normal((P, E), dtype=np.float32)).to("cuda", torch.bfloat16)
        for name, n in (("page_gather", n_gather), ("page_scatter", n_scatter)):
            ids = torch.from_numpy(rng.choice(P, size=n, replace=False).astype(np.int32)).cuda()
            pages = torch.from_numpy(rng.standard_normal((n, E), dtype=np.float32)).to("cuda", torch.bfloat16)
            if name == "page_gather":
                out, ref = page_gather(pool, ids), page_gather_ref(pool, ids)
                run = lambda: page_gather(pool, ids)                      # noqa: E731
                plain_fn = lambda: page_gather_ref(pool, ids)             # noqa: E731
                lib_fn = lambda: pool.index_select(0, ids)                # noqa: E731
            else:
                out = page_scatter(pool.clone(), ids, pages)
                ref = page_scatter_ref(pool.clone(), ids, pages)
                run = lambda: page_scatter(pool, ids, pages)              # noqa: E731
                plain_fn = lambda: page_scatter_ref(pool, ids, pages)     # noqa: E731
                lib_fn = lambda: pool.index_copy_(0, ids.long(), pages)   # noqa: E731
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"{name} {case}: not bitwise equal to its plain version")
            times = measure(torch, flush, run, plain_fn, lib_fn)
            bnd, by = bound_ms(2.0 * n * E * pool.element_size() + 4 * n, 0.0, "bfloat16")
            row = dict(case=case, name=name, pages=n, max_abs_err=0.0, **times,
                       bound_ms=bnd, bound_by=by)
            report["copies"].append(row)
    report["engine_copies"] = engine_copy_cases(torch, flush)
    report["weight_copies"] = weight_copy_cases(torch, flush)
    report["out_of_range_ids"] = out_of_range_cases(torch)
    for name, case in COPY_MAIN_CASE.items():
        serve[name] = next(r for r in report["engine_copies"] if r["case"] == case)
    report["flash"] = flash_cases(torch, rng, flush)
    serve["flash_attention"] = next(r for r in report["flash"]
                                    if r["case"] == "qwen2_4096" and r["dtype"] == "bfloat16")
    # phase 9's shapes, for the kernels line
    serve["zoo_cases"] = {
        "paged_attention": [r for r in report["attention"] if r.get("window")],
        "flash_attention": [r for r in report["flash"] if r["case"] in ZOO_FLASH_CASES]}
    emit({"phase": "kernels", **report})
    serve["weight_copies"] = report["weight_copies"]
    return serve


def engine_copy_cases(torch, flush):
    """The engine's installs and copies-on-write at their call shapes, both
    pools (``COPY_CASES``): the layered kernels as the engine calls them
    (one launch per pool and copy), the parent's call pattern on this build
    (a zero-padded staging copy and one launch per layer, pool and copy),
    the plain versions and a library yardstick (``index_copy_`` /
    ``index_select`` over the layer axis, the install's source padded
    beforehand, the pad not timed), in turns.  Both kernel variants and
    the parent pattern are held bitwise to the plain version first."""
    from repro_torch.kernels.page_gather import kernel as CK
    from repro_torch.kernels.page_gather.ops import pool_rows, token_rows
    from repro_torch.kernels.page_gather.ref import page_gather_ref, page_scatter_ref

    rows = []
    ps, es = 16, 2
    for case, c in COPY_CASES.items():
        L, kvh, d, P = c["layers"], c["kvh"], c["d"], c["pages"]
        E = ps * kvh * d
        g = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

        pools = [randn(L, P, ps, kvh, d) for _ in range(2)]
        if c["kind"] == "install":
            S = c["tokens"]
            n = -(-S // ps)
            # the prefill cache [L, 1, bucket + 8, KVH, D]; positions 0..S
            caches = [randn(L, 1, -(-S // 32) * 32 + 8, kvh, d) for _ in range(2)]
            srcs = [token_rows(x[:, 0, :S]) for x in caches]
            ids = torch.randperm(P, generator=g, device="cuda")[:n].to(torch.int32)
            padded = [torch.zeros((L, n * ps, kvh, d), dtype=torch.bfloat16, device="cuda")
                      for _ in range(2)]
            for pad, x in zip(padded, caches):
                pad[:, :S] = x[:, 0, :S]
            padded = [pad.view(L, n, E) for pad in padded]
            ids_l = ids.long()

            def kernel(pools, variant=None):
                for pool, src in zip(pools, srcs):
                    CK.page_scatter(pool_rows(pool), ids, src, variant=variant)

            def parent(pools):           # _install_pages before the layer axis
                for pool, x in zip(pools, caches):
                    staged = torch.zeros((L, n * ps, kvh, d), dtype=pool.dtype, device="cuda")
                    staged[:, :S] = x[:, 0, :S]
                    staged = staged.view(L, n, -1)
                    for layer in range(L):
                        CK.page_scatter(pool[layer].view(P, -1), ids, staged[layer])

            def plain(pools):
                for pool, src in zip(pools, srcs):
                    page_scatter_ref(pool_rows(pool), ids, src)

            def library(pools):
                for pool, pad in zip(pools, padded):
                    pool_rows(pool).index_copy_(1, ids_l, pad)

            nbytes = 2 * (L * S * kvh * d * es + L * n * E * es) + 4 * n
            launches = {"page_scatter": 2}
            parent_launches = {"page_scatter": 2 * L}
        else:
            n, S = 1, None
            ids = torch.tensor([3, 11], dtype=torch.int32, device="cuda")
            src_ids, dst_ids = ids[:1], ids[1:]
            src_l, dst_l = src_ids.long(), dst_ids.long()
            gather_only = c["kind"] == "gather"

            def kernel(pools, variant=None):
                for pool in pools:
                    rows_ = pool_rows(pool)
                    got = CK.page_gather(rows_, src_ids, variant=variant)
                    if not gather_only:
                        CK.page_scatter(rows_, dst_ids, got, variant=variant)
                return got

            def parent(pools):           # _ensure_private before the layer axis
                for pool in pools:
                    for layer in pool:
                        lr = layer.view(P, -1)
                        got = CK.page_gather(lr, src_ids)
                        if not gather_only:
                            CK.page_scatter(lr, dst_ids, got)

            def plain(pools):
                for pool in pools:
                    rows_ = pool_rows(pool)
                    got = page_gather_ref(rows_, src_ids)
                    if not gather_only:
                        page_scatter_ref(rows_, dst_ids, got)
                return got

            def library(pools):
                for pool in pools:
                    rows_ = pool_rows(pool)
                    got = rows_.index_select(1, src_l)
                    if not gather_only:
                        rows_.index_copy_(1, dst_l, got)

            nbytes = 2 * 2 * L * E * es + 4 * (1 if gather_only else 2)
            launches = ({"page_gather": 2} if gather_only else
                        {"page_gather": 2, "page_scatter": 2})
            parent_launches = {k: v * L for k, v in launches.items()}

        # bitwise: both variants and the parent pattern against the plain version
        want = [p.clone() for p in pools]
        want_out = plain(want)
        for var in (*CK.VARIANTS, "parent"):
            got = [p.clone() for p in pools]
            before = {k: dict(v) for k, v in CK.copy_variant_counts.items()}
            out = parent(got) if var == "parent" else kernel(got, var)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"page copies {case} {var}: pools not bitwise equal to the plain version")
            if want_out is not None and var != "parent":
                check(torch.equal(out, want_out),
                      f"page_gather {case} {var}: not bitwise equal to the plain version")
            if var != "parent":
                check(all(CK.copy_variant_counts[k][var] - before[k][var] == launches[k]
                          for k in launches), f"page copies {case}: {var} launches not counted")
            del got
        del want
        before = {k: dict(v) for k, v in CK.copy_variant_counts.items()}
        kernel(pools)                    # the variant the engine's call takes
        taken = {k: {v: CK.copy_variant_counts[k][v] - before[k][v] for v in CK.VARIANTS}
                 for k in launches}
        variant = "bulk" if all(t["bulk"] == launches[k] for k, t in taken.items()) else taken
        times = measure(torch, flush, lambda: kernel(pools), lambda: plain(pools),
                        lambda: library(pools),
                        {"generic_ms": lambda: kernel(pools, "generic"),
                         "parent_ms": lambda: parent(pools)})
        bnd, by = bound_ms(nbytes, 0.0, "bfloat16")
        rows.append(dict(case=case, layers=L, pools=2, pages=n, tokens=S,
                         page_bytes=E * es, kind=c["kind"], launches=launches,
                         parent_launches=parent_launches, variant=variant,
                         variant_ms={"bulk": times["ms"], "generic": times.pop("generic_ms")},
                         max_abs_err=0.0, **times, bound_ms=bnd, bound_by=by))
        del pools
        if c["kind"] == "install":
            del caches, srcs, padded
        torch.cuda.empty_cache()
    return rows


def weight_copy_cases(torch, flush):
    """The weight pager's install and read of one qwen2-1.5b layer (47 pages
    of 2 MiB) on its [376, 1048576] bf16 pool, the Pallas ``[P, E]``
    contract: both variants held bitwise to the plain version, then the
    kernel, the generic variant, the plain version and ``index_copy_`` /
    ``index_select`` timed in turns."""
    from repro_torch.kernels.page_gather import kernel as CK
    from repro_torch.kernels.page_gather.ref import page_gather_ref, page_scatter_ref

    rows = []
    P, E = WEIGHT_POOL
    n = WEIGHT_LAYER_PAGES
    g = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.randn((P, E), generator=g, device="cuda").to(torch.bfloat16)
    pages = torch.randn((n, E), generator=g, device="cuda").to(torch.bfloat16)
    ids = torch.randperm(P, generator=g, device="cuda")[:n].to(torch.int32)
    ids_l = ids.long()
    for case, name in WEIGHT_COPY_CASES.items():
        if name == "page_scatter":
            kernel = lambda variant=None: CK.page_scatter(pool, ids, pages, variant=variant)  # noqa: E731
            plain = lambda: page_scatter_ref(pool, ids, pages)                               # noqa: E731
            library = lambda: pool.index_copy_(0, ids_l, pages)                              # noqa: E731
            want = page_scatter_ref(pool.clone(), ids, pages)
        else:
            kernel = lambda variant=None: CK.page_gather(pool, ids, variant=variant)          # noqa: E731
            plain = lambda: page_gather_ref(pool, ids)                                       # noqa: E731
            library = lambda: pool.index_select(0, ids_l)                                    # noqa: E731
            want = page_gather_ref(pool, ids)
        for var in CK.VARIANTS:
            before = CK.copy_variant_counts[name][var]
            if name == "page_scatter":
                got = CK.page_scatter(pool.clone(), ids, pages, variant=var)
            else:
                got = kernel(var)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{case} {var}: not bitwise equal to the plain version")
            check(CK.copy_variant_counts[name][var] == before + 1, f"{case}: {var} launch not counted")
            del got
        del want
        before = CK.copy_variant_counts[name]["bulk"]
        kernel()
        torch.cuda.synchronize()
        variant = "bulk" if CK.copy_variant_counts[name]["bulk"] == before + 1 else "generic"
        times = measure(torch, flush, kernel, plain, library,
                        {"generic_ms": lambda: kernel("generic")})
        nbytes = 2.0 * n * E * pool.element_size() + 4 * n     # pages read + written, ids
        bnd, by = bound_ms(nbytes, 0.0, "bfloat16")
        rows.append(dict(case=case, name=name, pool=[P, E], pages=n, page_bytes=E * 2,
                         variant=variant,
                         variant_ms={"bulk": times["ms"], "generic": times.pop("generic_ms")},
                         max_abs_err=0.0, **times, bound_ms=bnd, bound_by=by,
                         gb_per_s=nbytes / times["ms"] / 1e6))
    del pool, pages
    torch.cuda.empty_cache()
    return rows


def out_of_range_cases(torch):
    """Page ids outside [0, P) on the card, as the reference treats them
    (jnp.take wraps [-P, 0) and fills the rest; .at[].set wraps and drops
    the rest): each variant, [P, E] and layered, bf16 / fp32 / int32,
    held bitwise to the plain version, which the CPU tests hold to JAX."""
    from repro_torch.kernels.page_gather import kernel as CK
    from repro_torch.kernels.page_gather.ref import page_gather_ref, page_scatter_ref

    ids = torch.tensor([5, -1, 40, 7, 1 << 30, -40, -41, -(1 << 31)], dtype=torch.int32,
                       device="cuda")
    held = []
    for dtype in ("bfloat16", "float32", "int32"):
        for lead in ((), (3,)):
            g = torch.Generator(device="cuda").manual_seed(1)
            pool = torch.randn(lead + (40, 3072), generator=g, device="cuda") * 1000
            pages = torch.randn(lead + (8, 3072), generator=g, device="cuda") * 1000
            pool, pages = (t.to(getattr(torch, dtype)) for t in (pool, pages))
            want_g = page_gather_ref(pool, ids).view(torch.uint8)
            want_s = page_scatter_ref(pool.clone(), ids, pages).view(torch.uint8)
            for var in CK.VARIANTS:
                got = CK.page_gather(pool, ids, variant=var)
                out = CK.page_scatter(pool.clone(), ids, pages, variant=var)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.uint8), want_g),
                      f"page_gather out-of-range ids {dtype} {lead} {var}: not the plain answer")
                check(torch.equal(out.view(torch.uint8), want_s),
                      f"page_scatter out-of-range ids {dtype} {lead} {var}: not the plain answer")
                held.append(f"{dtype}{list(lead + (40, 3072))}:{var}")
    return {"ids": ids.tolist(), "pool_pages": 40, "held": held}


def visible_pairs(B, sq, sk, causal, window):
    """(q, k) pairs the mask leaves visible: what the work depends on."""
    import numpy as np

    qp = np.arange(sq)
    hi = np.minimum(qp + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(sq, np.int64)
    return B * int(np.clip(hi - lo, 0, None).sum())


def sdpa_flash_yardstick(torch, q, k, v, nh, causal, window):
    """One library call on the real heads (contiguous copies made
    beforehand, not timed); timed only, the port never calls it."""
    import torch.nn.functional as F

    qh, kc, vc = q[:, :nh].contiguous(), k.contiguous(), v.contiguous()
    kw = {"is_causal": causal and window is None}
    if window is not None:
        qp = torch.arange(q.shape[2], device="cuda")[:, None]
        kp = torch.arange(k.shape[2], device="cuda")[None, :]
        kw = {"attn_mask": (qp - kp < window) & ((kp <= qp) if causal else True)}
    return lambda: F.scaled_dot_product_attention(qh, kc, vc, enable_gqa=True, **kw)


def max_row_rel_err(out, ref, name):
    """Largest ||out - ref|| / ||ref|| over the rows (last axis) of ``ref``
    that are not zero; rows where ``ref`` is zero must be zero in ``out``."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    live = norm > 0
    check(bool((diff[~live] == 0).all()), f"{name}: a zero row of the plain version is not zero")
    return (diff[live] / norm[live]).max().item()


def flash_cases(torch, rng, flush):
    """flash_attention against its plain version, q/k/v as the model hands
    them over: [B,S,*,D] tensors viewed as [B,*,S,D]."""
    import numpy as np

    from repro_torch.kernels.flash_attention.kernel import choose_variant, flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rows = []
    for case, (B, H, NH, KVH, sq, sk, D, causal, window) in FLASH_CASES.items():
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                       .to("cuda", dt).transpose(1, 2)
                       for shape in ((B, sq, H, D), (B, sk, KVH, D), (B, sk, KVH, D)))
            kw = dict(causal=causal, window=window, num_heads=NH)
            variant = choose_variant(q, k, v)
            ref = flash_attention_ref(q, k, v, **kw)
            # the chosen variant, and where that is the hopper kernel, the
            # generic one too: both are held to the plain version and timed
            checked = {}
            for var in dict.fromkeys((variant, "generic")):
                out = flash_attention(q, k, v, variant=var, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                tol = TOL[dtype]
                ok = bool((err <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
                check(ok, f"flash_attention {case} {dtype} {var}: max |err| {err.max().item()}")
                row_err = max_row_rel_err(out, ref, "flash_attention")
                check(row_err <= ROW_REL_TOL[dtype],
                      f"flash_attention {case} {dtype} {var}: row relative error {row_err}")
                check(bool((out[:, NH:] == 0).all()),
                      "flash_attention: padded heads must be zero")
                checked[var] = (err.max().item(), row_err)
                del out, err
            err_max, row_err = checked[variant]
            others = ({} if variant == "generic" else
                      {"generic_ms": lambda: flash_attention(q, k, v, variant="generic", **kw)})
            times = measure(torch, flush, lambda: flash_attention(q, k, v, **kw),
                            lambda: flash_attention_ref(q, k, v, **kw),
                            sdpa_flash_yardstick(torch, q, k, v, NH, causal, window), others)
            pairs = visible_pairs(B, sq, sk, causal, window)
            isz = q.element_size()
            nbytes = (B * NH * sq * D + 2 * B * KVH * sk * D + B * H * sq * D) * isz
            bnd, by = bound_ms(nbytes, 4.0 * D * NH * pairs, dtype)
            variant_ms = {variant: times["ms"]}
            if "generic_ms" in times:
                variant_ms["generic"] = times.pop("generic_ms")
            rows.append(dict(case=case, dtype=dtype, q=[B, H, sq, D], num_heads=NH, kvh=KVH,
                             sk=sk, causal=causal, window=window, visible_pairs=pairs,
                             variant=variant, variant_ms=variant_ms,
                             variant_errors={v: {"max_abs_err": e, "max_row_rel_err": r}
                                             for v, (e, r) in checked.items()},
                             max_abs_err=err_max, max_row_rel_err=row_err,
                             **times, bound_ms=bnd, bound_by=by))
            del q, k, v, ref
    return rows


# ------------------------------------------------------------------ phase 3


class InstallTimer:
    """Host ms of each install (``_install_pages`` with S > 0) of an engine
    module while active: the host's own cost of the call, not synchronised."""

    def __init__(self, engine_module):
        self.module, self.ms = engine_module, []

    def __enter__(self):
        self.original = self.module._install_pages
        self.module._install_pages = self._timed
        return self

    def __exit__(self, *exc):
        self.module._install_pages = self.original

    def _timed(self, cache, k, *args, **kw):
        t0 = time.perf_counter()
        out = self.original(cache, k, *args, **kw)
        if k.shape[1]:
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def summary(self) -> dict:
        ms = sorted(self.ms)
        return {"calls": len(ms), "mean_ms": sum(ms) / max(len(ms), 1),
                "median_ms": ms[len(ms) // 2] if ms else None, "max_ms": ms[-1] if ms else None}


def copy_variants_now():
    from repro_torch.kernels.page_gather import kernel as CK

    return {k: dict(v) for k, v in CK.copy_variant_counts.items()}


def check_copy_launches(path, launches, variants, eng) -> dict:
    """Page-copy launches of a path within one per pool of each attention
    segment for each install (a prefill or a prefix) and copy-on-write, and
    within ``LAUNCH_CAPS``; every one on the bulk variant.  Returns the
    bounds held."""
    installs = eng.stats["prefills"] + len(eng._prefixes)
    cows = eng.stats["cow_copies"]
    pools = 2 * sum(seg.has_attention for seg in eng.plan)
    caps = {"page_scatter": min(LAUNCH_CAPS[path]["page_scatter"], pools * (installs + cows)),
            "page_gather": min(LAUNCH_CAPS[path]["page_gather"], pools * cows)}
    for name, cap in caps.items():
        check(launches[name] <= cap,
              f"{path}: {launches[name]} {name} launches, at most {cap} expected")
        check(variants[name] == {"bulk": launches[name], "generic": 0},
              f"{path}: {name} launches by variant {variants[name]}, all should be bulk")
    return caps


def make_requests(cfg, Request, n, seed, prefix):
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        L = int(rng.integers(4, 24))
        reqs.append(Request(rid=rid, max_new_tokens=16, deadline_s=120.0,
                            prompt=rng.integers(0, cfg.vocab_size, size=L).astype(np.int32)))
    cow = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=1).astype(np.int32)])
    reqs.append(Request(rid=n, prompt=cow, max_new_tokens=16, deadline_s=120.0))
    return reqs


def serve(torch, cfg, params, n_requests, seed):
    import numpy as np

    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(
        max_batch=8, page_size=16, num_pages=512, max_pages_per_seq=32,
        prefill_bucket=32), device="cuda")
    prefix = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, size=20).astype(np.int32)
    reqs = make_requests(cfg, Request, n_requests, seed, prefix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.register_prefix(prefix)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=10_000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(eng.finished) == len(reqs) and not eng.active and not eng.waiting,
          "engine did not drain")
    check(all(r.done and not r.expired for r in eng.finished), "a request expired")
    prefix_pages = sum(len(p.pages) for p in eng._prefixes.values())
    check(eng.allocator.used_pages == 1 + prefix_pages, "pool pages leaked")
    for r in eng.finished:
        check(all(0 <= t < cfg.vocab_size for t in r.generated), "token outside the vocabulary")
    return eng, reqs, seconds


def device_kernels(prof, ranges=()):
    """(device-side events of a torch.profiler run, device us of one).  CPU
    ops also carry their kernels' time, so only device events count; the
    device-side spans of the ``record_function`` ranges named in ``ranges``
    are no kernels and do not count either."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    return ([e for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0
             and e.key not in ranges], dev_us)


def range_ms(prof, name):
    """Device ms of the kernels launched by the ops inside the
    ``record_function(name)`` ranges (their host-side events; the
    device-side span of a range also covers the gaps between its kernels),
    or None where the profiler attributes no kernel to them."""
    us = 0.0
    for e in prof.events():
        if e.name == name and str(getattr(e, "device_type", "")).endswith("CPU"):
            us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return us / 1e3 if us else None


def step_profile(torch, eng, steps: int, ranges=()) -> dict:
    """Decode steps of a warmed engine, timed without and then with
    ``torch.profiler``: host wall ms per step, device busy ms and ops per
    step, idle share, ``paged_attention``'s device ms and share, the
    costliest device ops, and the device ms per step of each named
    ``record_function`` range in ``ranges``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_step_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, dev_us = device_kernels(prof, ranges)
    check(kernels, "profile: torch.profiler saw no device time")
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    attn = [e for e in kernels if "paged_attention" in e.key]
    attn_ms = sum(dev_us(e) for e in attn) / 1e3 / steps
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    in_ranges = {}
    for name in ranges:
        ms = range_ms(prof, name)
        in_ranges[name] = None if ms is None else ms / steps
    return {"steps": steps, "step_ms": step_ms, "profiled_step_ms": prof_step_ms,
            "ranges_ms_per_step": in_ranges,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / prof_step_ms,
            "device_ops_per_step": sum(e.count for e in kernels) / steps,
            "paged_attention_ms_per_step": attn_ms,
            "paged_attention_launches_per_step": sum(e.count for e in attn) / steps,
            "paged_attention_share_of_busy": attn_ms / busy_ms,
            "paged_attention_share_of_step": attn_ms / prof_step_ms,
            "top_device_ops": [{"name": e.key[:80], "calls_per_step": e.count / steps,
                                "ms_per_step": dev_us(e) / 1e3 / steps} for e in top]}


def phase_profile(torch, cfg, params, steps: int = 8):
    """Where a decode step's time goes: 8 full lanes of the main path's
    engine."""
    import numpy as np

    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(
        max_batch=8, page_size=16, num_pages=512, max_pages_per_seq=32,
        prefill_bucket=32), device="cuda")
    rng = np.random.default_rng(11)
    for rid in range(8):
        eng.submit(Request(rid=rid, max_new_tokens=4 + 2 * steps,
                           prompt=rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)))
    for _ in range(2):                        # admit all lanes, warm up
        eng.step()
    check(len(eng.active) == 8, "profile: expected 8 live lanes")
    emit({"phase": "profile", "lanes": 8, **step_profile(torch, eng, steps)})


def contiguous_decode(torch, M, cfg, params, prompt, n_new, forced=None, plain=False):
    """Unbatched greedy decode through a contiguous cache; with ``forced``
    tokens, teacher-forced; with ``plain``, the prefill is given explicit
    positions and so takes the plain attention route, not the kernel.
    Positions count a model's meta tokens ahead of the prompt, as the
    engine's do.  Returns (tokens, per-step logits)."""
    toks = [int(t) for t in prompt]
    m = cfg.num_meta_tokens
    cache = M.init_cache(cfg, 1, len(toks) + n_new + 8 + m, device="cuda")
    batch = {"tokens": torch.tensor([toks[:-1]], dtype=torch.int32, device="cuda")}
    if plain:
        batch["positions"] = torch.arange(len(toks) - 1, dtype=torch.int32,
                                          device="cuda")[None, :]
    _, cache = M.prefill(cfg, params, batch, cache)
    out, logits_all = [], []
    cur = len(toks) - 1 + m
    for i in range(n_new):
        logits, cache = M.decode_step(cfg, params, cache,
                                      torch.tensor([toks[-1]], dtype=torch.int32, device="cuda"),
                                      torch.tensor([cur], dtype=torch.int32, device="cuda"))
        logits_all.append(logits[0, :cfg.vocab_size].float())
        nxt = int(logits[0].argmax()) if forced is None else int(forced[i])
        out.append(nxt)
        toks.append(nxt)
        cur += 1
    return out, logits_all


# ------------------------------------------------------------------ phase 6


LONG_ENGINE = dict(max_batch=4, page_size=16, num_pages=1408, max_pages_per_seq=264,
                   prefill_bucket=32)


def long_prompt_requests(cfg, Request, seed=0, lens=None):
    """4 prompts of 1024-4096 tokens and one of exactly 4096, x 16 new."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = lens or [int(n) for n in rng.integers(1024, 4097, size=4)] + [4096]
    return [Request(rid=i, max_new_tokens=16, deadline_s=600.0,
                    prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32))
            for i, n in enumerate(lens)]


def serve_timed(torch, cfg, params, ecfg, reqs, prefix=None):
    """Register ``prefix`` (if any) and drain ``reqs`` through a fresh
    engine.  Returns (engine, seconds)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, ecfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if prefix is not None:
        eng.register_prefix(prefix)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=10_000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(eng.finished) == len(reqs) and not eng.active and not eng.waiting,
          f"{cfg.name}: engine did not drain")
    check(all(r.done and not r.expired for r in eng.finished), f"{cfg.name}: a request expired")
    prefix_pages = sum(len(p.pages) for p in eng._prefixes.values())
    check(eng.allocator.used_pages == 1 + prefix_pages, f"{cfg.name}: pool pages leaked")
    for r in eng.finished:
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{cfg.name}: token outside the vocabulary")
    return eng, seconds


def profile_prefill(torch, eng, prompt, phase="long_prompt_prefill_profile", ranges=()):
    """Where one long prefill's time goes: host wall ms with and without
    ``torch.profiler``, device busy ms, the costliest device ops, and the
    device ms of each named ``record_function`` range in ``ranges``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._run_prefill(prompt)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._run_prefill(prompt)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels, dev_us = device_kernels(prof, ranges)
    check(kernels, "prefill profile: torch.profiler saw no device time")
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    flash = [e for e in kernels if "flash" in e.key]
    flash_ms = sum(dev_us(e) for e in flash) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    in_ranges = {name: range_ms(prof, name) for name in ranges}
    emit({"phase": phase, "prompt_tokens": len(prompt),
          "ranges_ms": in_ranges,
          "ranges_share_of_busy": {k: v / busy_ms for k, v in in_ranges.items() if v},
          "wall_ms": wall_ms, "profiled_wall_ms": prof_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / prof_ms,
          "device_ops": sum(e.count for e in kernels),
          "flash_attention_ms": flash_ms,
          "flash_attention_launches": sum(e.count for e in flash),
          "flash_attention_kernels": sorted({e.key[:60] for e in flash}),
          "flash_attention_share_of_busy": flash_ms / busy_ms,
          "top_device_ops": [{"name": e.key[:80], "calls": e.count, "ms": dev_us(e) / 1e3}
                             for e in top]})


def profile_long_decode(torch, cfg, params, steps: int = 8):
    """Where a long-context decode step's time goes: a fresh engine with
    the first wave's 4 requests (1853-3637-token prompts) live in its 4
    lanes, prefilled, then warmed by one more step."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(**LONG_ENGINE), device="cuda")
    reqs = long_prompt_requests(cfg, Request, seed=0)[:4]
    for r in reqs:
        r.max_new_tokens = 2 * steps + 4
        eng.submit(r)
    for _ in range(2):                        # admit (prefill) all lanes, warm up
        eng.step()
    check(len(eng.active) == 4, "long decode profile: expected 4 live lanes")
    contexts = [eng.seq_len[r.rid] for r in reqs]
    emit({"phase": "long_decode_profile", "arch": cfg.name, "lanes": 4,
          "contexts_at_start": contexts, **step_profile(torch, eng, steps)})


def phase_long_prompt(torch, M, K):
    """Long prompts on full-width qwen2-1.5b: the prefill path through
    flash_attention, then decode through paged_attention.  Returns (launch
    counts, flash_attention's launches by variant, the page copies' launches
    by variant, the bf16 weights)."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    import repro_torch.serve.engine as engine_module
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.page_gather import kernel as CK
    from repro_torch.models.transformer import cast_params
    from repro_torch.serve.engine import EngineConfig, Request

    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")       # fp32, one init for both
    init_s = time.perf_counter() - t0

    # fp32 first: an 1100-token request, engine tokens equal to the plain
    # route's; then only the bf16 weights stay on the card
    cfg32 = cfg.replace(compute_dtype="float32")
    prompt32 = np.random.default_rng(2).integers(0, cfg.vocab_size, size=1100)
    req32 = Request(rid=0, max_new_tokens=8, deadline_s=600.0, prompt=prompt32.astype(np.int32))
    serve_timed(torch, cfg32, params, EngineConfig(
        max_batch=1, page_size=16, num_pages=160, max_pages_per_seq=80,
        prefill_bucket=32), [req32])
    ref32, _ = contiguous_decode(torch, M, cfg32, params, req32.prompt, 8, plain=True)
    check(ref32 == req32.generated,
          f"long prompt fp32: paged {req32.generated} != contiguous plain route {ref32}")
    params = cast_params(cfg, params)
    torch.cuda.empty_cache()

    ecfg = EngineConfig(**LONG_ENGINE)
    warm = long_prompt_requests(cfg, Request, seed=1, lens=[4096])   # cuBLAS, allocator
    warm[0].max_new_tokens = 2
    serve_timed(torch, cfg, params, ecfg, warm)

    # the 4096-token request's first 4095 tokens are a registered prefix (a
    # shared document): it maps 256 shared pages and copies the partial last
    # one on its first decode write (page_gather + page_scatter)
    reqs = long_prompt_requests(cfg, Request, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    CK.reset_copy_variant_counts()
    with InstallTimer(engine_module) as installs:
        eng, seconds = serve_timed(torch, cfg, params, ecfg, reqs, prefix=reqs[-1].prompt[:-1])
    launches = dict(K.launch_counts)
    variants = dict(FK.variant_counts)
    copy_variants = copy_variants_now()
    peak = torch.cuda.max_memory_allocated()        # bf16 weights, pools, activations
    # every generated token comes out of a decode step: a prefill covers
    # prompt[:-1] and the last prompt token is the first decode input
    tokens = sum(len(r.generated) for r in eng.finished)
    done = sorted(eng.finished, key=lambda r: r.rid)
    prefill_s = sum(r.prefill_ms for r in done) / 1e3
    emit({"phase": "long_prompt", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "init_params_s": init_s, "prompt_tokens": [len(r.prompt) for r in reqs],
          "requests_served": len(eng.finished), "tokens": tokens, "seconds": seconds,
          "tok_per_s": tokens / seconds,
          "prefill_ms": [[len(r.prompt) - 1, r.prefill_ms] for r in done],
          "prefill_share": prefill_s / seconds,
          "decode_tok_per_s": tokens / (seconds - prefill_s),
          "request_latency_s": [r.latency_s for r in done],
          "steps": eng.stats["steps"], "peak_pages_used": eng.stats["peak_pages_used"],
          "prefix_hits": eng.stats["prefix_hits"], "cow_copies": eng.stats["cow_copies"],
          "peak_memory_bytes": peak, "launches": launches,
          "flash_attention_variants": variants, "copy_variants": copy_variants,
          "copy_launch_bounds": check_copy_launches("long_prompt", launches, copy_variants, eng),
          "install_host_ms": installs.summary()})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the long-prompt path")
    check(variants == {"hopper": launches["flash_attention"], "generic": 0},
          f"long prompt bf16: flash_attention launches by variant {variants}, "
          f"all {launches['flash_attention']} should be hopper")
    profile_prefill(torch, eng, reqs[-1].prompt[:-1])
    profile_long_decode(torch, cfg, params)

    # bf16: each token of the shortest request within tolerance of the
    # maximum logit of a teacher-forced contiguous decode (plain route)
    short = min(eng.finished, key=lambda r: len(r.prompt))
    _, logits = contiguous_decode(torch, M, cfg, eng.params, short.prompt, 16,
                                  forced=short.generated, plain=True)
    tol = TOL["bfloat16"]
    margins = []
    for step, (lg, tok) in enumerate(zip(logits, short.generated)):
        check(bool(torch.isfinite(lg).all()), "long prompt: non-finite logits")
        top = lg.max()
        gap = (top - lg[tok]).item()
        margins.append(gap)
        check(gap <= tol["atol"] + tol["rtol"] * abs(top.item()),
              f"long prompt bf16 step {step}: token {tok} is {gap} below the contiguous max")
    emit({"phase": "long_prompt_check", "bf16_prompt_tokens": len(short.prompt),
          "bf16_max_gap_to_top_logit": max(margins),
          "bf16_tokens_equal_to_contiguous_argmax": sum(m == 0.0 for m in margins),
          "fp32_prompt_tokens": len(req32.prompt), "fp32_tokens_equal": len(ref32)})
    del eng, logits
    torch.cuda.empty_cache()
    return launches, variants, copy_variants, params


# ------------------------------------------------------------------ phase 7


def layer_images(torch, params):
    """Each decoder layer's weights as one flat bf16 image (numpy ``uint16``
    bit patterns, leaves in tree order), and the (treedef, shapes) that view
    an image as the layer's tree."""
    from repro_torch.interop import to_numpy, tree_flatten, tree_map

    (stacked,) = params["segments"]
    count = tree_flatten(stacked)[0][0].shape[0]
    images = []
    for i in range(count):
        leaves, treedef = tree_flatten(tree_map(lambda a: a[i], stacked))
        images.append(to_numpy(torch.cat([t.reshape(-1) for t in leaves])))
    return images, treedef, [tuple(t.shape) for t in leaves]


def layer_views(flat, treedef, shapes):
    """A flat layer back into its parameter tree, as views of ``flat``."""
    import numpy as np

    from repro_torch.interop import tree_unflatten

    leaves, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        leaves.append(flat[off:off + n].view(shape))
        off += n
    return tree_unflatten(treedef, leaves)


def fetch_breakdown(torch, region, specs, count=4):
    """Where a layer fetch's host time goes, one layer at a time on this
    thread, for the first ``count`` layers: the lease (the core pager's
    fills of 47 pages from the store into the page buffer; these layers are
    not resident after a sweep) and
    the pageable host-to-device copies of the lease views, synchronised."""
    from repro_torch.kernels.page_gather.kernel import copy_h2d

    staged = torch.empty((specs[0]["npages"], WEIGHT_PAGE_BYTES), dtype=torch.uint8,
                         device="cuda")
    rows = []
    for i, spec in enumerate(specs[:count]):
        t0 = time.perf_counter()
        with region.lease_run(spec["first_page"], spec["npages"]) as run:
            t1 = time.perf_counter()
            for row, view in zip(staged, run.views):
                copy_h2d(row, view.ctypes.data, view.nbytes)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        nbytes = spec["npages"] * WEIGHT_PAGE_BYTES
        rows.append({"layer": i, "lease_ms": (t1 - t0) * 1e3, "h2d_ms": (t2 - t1) * 1e3,
                     "lease_gb_per_s": nbytes / (t1 - t0) / 1e9,
                     "h2d_gb_per_s": nbytes / (t2 - t1) / 1e9})
    return rows


def phase_weight_pager(torch, K, cfg, params):
    """Full-width qwen2-1.5b prefill with its layer weights streamed from a
    host region through ``RegionLayerSource`` and ``LayerWeightPager``.
    Returns the launch counts of the two counted passes."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.models.transformer as T
    from repro_torch.core import HostArrayStore, UMapConfig, umap, uunmap
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.page_gather import kernel as CK
    from repro_torch.models.blocks import BlockCtx, block_apply
    from repro_torch.models.layers import rms_norm
    from repro_torch.serve.weight_pager import (LayerWeightPager, RegionLayerSource,
                                                pack_layer_arrays)

    t0 = time.perf_counter()
    images, treedef, shapes = layer_images(torch, params)
    layer_elems = int(images[0].size)
    buf, specs = pack_layer_arrays(images, WEIGHT_PAGE_BYTES)
    del images
    pack_s = time.perf_counter() - t0
    per_layer = specs[0]["npages"]
    check(per_layer == WEIGHT_LAYER_PAGES and all(s["npages"] == per_layer for s in specs),
          f"weight pager: {per_layer} pages a layer, {WEIGHT_LAYER_PAGES} expected")
    region = umap(HostArrayStore(buf), config=UMapConfig(
        page_size=WEIGHT_PAGE_BYTES, buffer_size=WEIGHT_BUFFER_BYTES,
        max_lease_run=max(64, per_layer)))
    (seg,) = cfg.decoder_plan()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, WEIGHT_PROMPT)).astype(np.int32)).cuda()
    positions = torch.arange(WEIGHT_PROMPT, dtype=torch.int32, device="cuda")[None]
    ctx = BlockCtx(mode="prefill", positions=positions, default_positions=True)
    pager = None
    try:
        src = RegionLayerSource(region, specs, device="cuda", dtype=torch.bfloat16,
                                pool_pages=WEIGHT_POOL_LAYERS * per_layer)
        pager = LayerWeightPager(src, num_slots=4, readahead=2, device="cuda", num_fillers=2)

        def apply(flat, x, i):
            return block_apply(cfg, seg, layer_views(flat, treedef, shapes), x, ctx)[0]

        def paged_pass():
            x = pager.run(T.embed_tokens(cfg, params, tokens), apply)
            return rms_norm(x, params["final_norm"], cfg.norm_eps)[:, -1]

        def resident():
            return T.prefill(cfg, params, {"tokens": tokens}, [None])[0]

        def leased():
            return region.stats()["leases"]

        want = resident()                # warm-up, and the reference
        # explicit positions: the plain attention route, not flash_attention
        plain = T.prefill(cfg, params, {"tokens": tokens, "positions": positions},
                          [None])[0].float()
        resident_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resident()
            torch.cuda.synchronize()
            resident_ms.append((time.perf_counter() - t0) * 1e3)

        leases0 = leased()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        FK.reset_variant_counts()
        CK.reset_copy_variant_counts()
        pass_ms, pass_pages = [], []
        for _ in range(2):
            before = leased()
            t0 = time.perf_counter()
            got = paged_pass()
            torch.cuda.synchronize()
            pass_ms.append((time.perf_counter() - t0) * 1e3)
            pass_pages.append(leased() - before)
            check(torch.equal(got, want),
                  "weight pager: the paged prefill is not bitwise equal to the resident one")
            if len(pass_ms) == 1:
                plain_rel = ((got.float() - plain).norm() / plain.norm()).item()
        launches = dict(K.launch_counts)
        flash_variants = dict(FK.variant_counts)
        copy_variants = copy_variants_now()
        peak = torch.cuda.max_memory_allocated()
        leases = leased() - leases0
        stats = dict(pager.stats)
        installs, reads = leases // per_layer, stats["fills"]

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            before = leased()
            t0 = time.perf_counter()
            got = paged_pass()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
            prof_pages = leased() - before
        check(torch.equal(got, want), "weight pager: the profiled pass is not bitwise equal")
        breakdown = fetch_breakdown(torch, region, specs)
        kernels, dev_us = device_kernels(prof)
        check(kernels, "weight pager profile: torch.profiler saw no device time")
        h2d = [e for e in kernels if "HtoD" in e.key]
        h2d_ms = sum(dev_us(e) for e in h2d) / 1e3
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=dev_us, reverse=True)[:8]
        emit({"phase": "weight_pager", "arch": cfg.name, "dtype": cfg.compute_dtype,
              "prompt_tokens": WEIGHT_PROMPT, "layers": len(specs),
              "layer_elems": layer_elems, "layer_pages": per_layer,
              "page_bytes": WEIGHT_PAGE_BYTES, "packed_bytes": int(buf.nbytes),
              "pack_s": pack_s, "buffer_bytes": WEIGHT_BUFFER_BYTES,
              "pool_pages": src.pool_pages, "pool_bytes": src.pool_pages * WEIGHT_PAGE_BYTES,
              "pager": {"num_slots": 4, "readahead": 2, "num_fillers": 2},
              "pass_ms": pass_ms, "pass_pages_fetched": pass_pages,
              "h2d_gb_per_s": [p * WEIGHT_PAGE_BYTES / ms / 1e6
                               for p, ms in zip(pass_pages, pass_ms)],
              "resident_prefill_ms": sorted(resident_ms)[len(resident_ms) // 2],
              "pager_stats": stats, "installs": installs, "reads": reads,
              "region_leases": leases, "plain_route_rel_err": plain_rel,
              "staging_copies": src.staging_copies, "peak_memory_bytes": peak,
              "fetch_breakdown": breakdown,
              "launches": launches, "flash_attention_variants": flash_variants,
              "copy_variants": copy_variants,
              "profiled_pass": {"wall_ms": prof_ms, "pages_fetched": prof_pages,
                                "device_busy_ms": busy_ms,
                                "device_idle_share": 1 - busy_ms / prof_ms,
                                "h2d_ms": h2d_ms, "h2d_copies": sum(e.count for e in h2d),
                                "h2d_device_gb_per_s": (prof_pages * WEIGHT_PAGE_BYTES
                                                        / h2d_ms / 1e6 if h2d_ms else None),
                                "kernel_busy_ms": busy_ms - h2d_ms,
                                "top_device_ops": [{"name": e.key[:80], "calls": e.count,
                                                    "ms": dev_us(e) / 1e3} for e in top]}})
        check(src.staging_copies == 0, f"weight pager: {src.staging_copies} staging copies")
        check(plain_rel <= WEIGHT_PLAIN_REL_TOL,
              f"weight pager: relative error {plain_rel} to the plain attention route")
        check(leases > 0 and leases % per_layer == 0 and installs <= reads,
              f"weight pager: {leases} leases for {reads} layer reads of {per_layer} pages")
        check(launches["page_scatter"] == installs and launches["page_gather"] == reads > 0,
              f"weight pager: {launches} for {installs} installs and {reads} reads")
        for name in ("page_scatter", "page_gather"):
            check(copy_variants[name] == {"bulk": launches[name], "generic": 0},
                  f"weight pager: {name} launches by variant {copy_variants[name]}")
        check(launches["flash_attention"] == 2 * len(specs)
              and flash_variants == {"hopper": launches["flash_attention"], "generic": 0},
              f"weight pager: flash_attention launches {launches['flash_attention']}, "
              f"by variant {flash_variants}")
        return launches, copy_variants
    finally:
        if pager is not None:
            pager.close()
        uunmap(region)


# ------------------------------------------------------------------ phase 8


def train_attention(torch, flush):
    """The training attention (``FlashVJPAttention``: chunked forward, flash
    backward) at full-width smollm's heads and phase 8's length, bf16 and
    fp32: its output and dq, dk, dv held per row against autograd through
    the plain ``_dense_attention``; forward + backward timed beside the
    dense route and ``scaled_dot_product_attention``'s."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.models.layers import AttnSpec, FlashVJPAttention, _dense_attention

    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, TRAIN_HEADS, TRAIN_HEAD_DIM
    spec = AttnSpec(causal=True, impl="chunked", chunk_size=TRAIN_ATTN_CHUNK)
    pos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s)
    rng = np.random.default_rng(0)
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
                       .to("cuda", dt).requires_grad_(True) for _ in range(4))
        do = do.detach()

        def chunked():
            o = FlashVJPAttention.apply(q, k, v, pos, pos, None, spec)
            return (o, *torch.autograd.grad(o, (q, k, v), do))

        def dense():
            o = _dense_attention(q, k, v, spec, pos, pos, None)
            return (o, *torch.autograd.grad(o, (q, k, v), do))

        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            return (o, *torch.autograd.grad(o, (qt, kt, vt), dot))

        got, want = chunked(), dense()
        errs = {"o": max_row_rel_err(got[0], want[0], f"train attention o ({dtype})")}
        unfloored, tensor = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            errs[name], unfloored[name], tensor[name] = grad_row_rel_err(g, w)
        del got, want
        for name, err in errs.items():
            tol = ROW_REL_TOL[dtype] if name == "o" else TRAIN_GRAD_ROW_TOL[dtype]
            check(err <= tol, f"train attention {name} ({dtype}): row error {err} > {tol}")
        for name, err in tensor.items():
            check(err <= TRAIN_GRAD_TENSOR_TOL[dtype],
                  f"train attention {name} ({dtype}): error {err} over the tensor")
        times = {}
        for key, fn in (("ms", chunked), ("dense_ms", dense), ("sdpa_ms", sdpa)):
            times[key] = time_ms(torch, fn, flush, reps=5, warmup=1)[0]
        out[dtype] = {"row_rel_err": errs, "grad_row_rel_err_unfloored": unfloored,
                      "grad_tensor_rel_err": tensor, **times}
        del q, k, v, do, qt, kt, vt
        torch.cuda.empty_cache()
    return {"shape": {"batch": b, "seq": s, "heads": h, "head_dim": d,
                      "chunk": TRAIN_ATTN_CHUNK, "causal": True},
            "forward_backward": out}


def grad_row_rel_err(got, want):
    """(largest ||got - want|| over a row divided by the larger of the row's
    ||want|| and the median row norm of ``want``; the same without the
    floor; ||got - want|| / ||want|| over the whole tensor).  A gradient row can be small by cancellation: dq of an early
    causal row sums a few ``p * (dp - D)`` terms, and the flash backward
    takes ``D = rowsum(do * o)`` from the saved ``o`` in the inputs'
    dtype, as the JAX package's does; so in bf16 such a row is not held to
    its own norm."""
    diff = (got.float() - want.float()).norm(dim=-1).flatten()
    norm = want.float().norm(dim=-1).flatten()
    live = norm > 0
    floored = (diff / norm.clamp(min=norm.median().item())).max().item()
    return (floored, (diff[live] / norm[live]).max().item(),
            (diff.norm() / norm.norm()).item())


def ooc_geometry(cfg, page_size):
    """(params pages, moments pages, largest leaf's pages) of the packed
    training state, from the parameter shapes alone."""
    import numpy as np

    from repro_torch.interop import tree_flatten
    from repro_torch.models.transformer import param_specs

    n = [int(np.prod(sp.shape)) for sp in tree_flatten(param_specs(cfg))[0]]
    pages = [max(1, -(-4 * x // page_size)) for x in n]
    return sum(pages), sum(max(1, -(-8 * x // page_size)) for x in n), max(pages)


def profiled(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: (its result, wall ms, device
    busy ms, of it host<->device copy ms, the costliest device ops)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, dev_us = device_kernels(prof)
    check(kernels, "train profile: torch.profiler saw no device time")
    busy = sum(dev_us(e) for e in kernels) / 1e3
    copies = sum(dev_us(e) for e in kernels if "HtoD" in e.key or "DtoH" in e.key) / 1e3
    top = [{"name": e.key[:80], "calls": e.count, "ms": dev_us(e) / 1e3}
           for e in sorted(kernels, key=dev_us, reverse=True)[:8]]
    return res, wall, busy, copies, top


def rel_norm(a, b) -> float:
    """||a - b|| / ||b|| over every leaf of two numpy trees together."""
    import numpy as np

    from repro_torch.interop import tree_flatten

    num = den = 0.0
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        num += float(np.sum((x - y) ** 2))
        den += float(np.sum(y ** 2))
    return (num / den) ** 0.5


def phase_train(torch, K, CK):
    """Full-width smollm-135m training at batch 4 x 2048 (phase 8).
    Returns the page copies' launches and variants of the paged run, and
    what phase 11 starts from (the seed-0 weights, the batches, the train
    config and the paged run's final state)."""
    import faulthandler

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.interop import to_numpy, tree_flatten, tree_map
    from repro_torch.launch import train as LT
    from repro_torch.train.ooc import OOCTrainer, OOCTrainerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    attention = train_attention(torch, flush)
    del flush
    torch.cuda.empty_cache()

    # 2. the resident Trainer, as the launcher builds and feeds it
    shard = ROOT / "build" / "train_tokens.bin"
    shard.parent.mkdir(parents=True, exist_ok=True)
    args = LT.parse_args(["--arch", "smollm-135m", "--device", "cuda", "--seed", "0",
                          "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                          "--seq", str(TRAIN_SEQ), "--data", str(shard)])
    LT.write_synthetic_shard(shard, TRAIN_STEPS * TRAIN_BATCH * (TRAIN_SEQ + 1) + 1024,
                             get_config(args.arch).vocab_size)
    t0 = time.perf_counter()
    trainer, loader, reader = LT.make_trainer(args, shard)
    init_s = time.perf_counter() - t0
    cfg, tcfg = trainer.cfg, trainer.tcfg.train
    check(cfg.num_layers == 30 and cfg.d_model == 576 and cfg.remat == "full"
          and cfg.attn_chunk == TRAIN_ATTN_CHUNK and cfg.vocab_size == 49152,
          f"train: unexpected config {cfg.name}")
    params0 = tree_map(to_numpy, trainer.params)      # the seed-0 weights, for 3-4
    data, step_ms = [], []
    try:
        for i, batch in zip(range(TRAIN_STEPS), loader):
            data.append(batch)
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            if i < TRAIN_STEPS - 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.fit([batch])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            else:
                peak = torch.cuda.max_memory_allocated()
                _, prof_ms, busy_ms, _, top = profiled(torch, lambda: trainer.fit([batch]))
    finally:
        reader.close()
        trainer.close()
    losses = [h["loss"] for h in trainer.metrics_log]
    check(trainer.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          f"train: {trainer.step} steps, {len(losses)} losses logged")
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= 0.5,
          f"train: first loss {losses[0]} not within 0.5 of ln V = {np.log(cfg.vocab_size)}")
    timed = sorted(step_ms[1:])
    resident = {"init_s": init_s, "losses": losses, "step_ms": step_ms,
                "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (timed[len(timed) // 2] / 1e3),
                "peak_memory_bytes": peak,
                "profiled_step": {"wall_ms": prof_ms, "device_busy_ms": busy_ms,
                                  "device_idle_share": 1 - busy_ms / prof_ms,
                                  "top_device_ops": top}}
    del trainer
    torch.cuda.empty_cache()
    batches = data[:OOC_STEPS]

    # 3. OOCTrainer, resident then paged, from the same weights and batches
    pt, mt, largest = ooc_geometry(cfg, OOC_PAGE)
    p_slots = max(2 * largest, pt // OOC_OVERSUB)
    ocfg = OOCTrainerConfig(page_size=OOC_PAGE, params_buffer_pages=p_slots,
                            moments_buffer_pages=max(8, (pt + mt) // OOC_OVERSUB - p_slots),
                            pool_pages=pt)
    runs = {}
    # a lease run the paging core cannot grant would retry forever
    # (ROADMAP.md, Queue 3): end the run with every thread's stack instead
    faulthandler.dump_traceback_later(OOC_WATCHDOG_S, exit=True)
    try:
        for mode in ("resident", "paged"):
            tr = OOCTrainer(cfg, tcfg, ocfg, paged=mode == "paged", params=params0,
                            device="cuda")
            try:
                if mode == "paged":
                    K.reset_launch_counts()
                    CK.reset_copy_variant_counts()
                rec = {"losses": [], "step_s": [], "grad_s": [], "sweep_s": [],
                       "sweep_copy_s": []}
                for batch in batches:
                    rec["losses"].append(tr.step(batch)["loss"])
                    for key in ("step_s", "grad_s", "sweep_s", "sweep_copy_s"):
                        rec[key].append(tr.stats["last_" + key])
                if mode == "paged":
                    launches, copy_variants = dict(K.launch_counts), copy_variants_now()
                    rec.update(oversubscription=tr.oversubscription(),
                               state_bytes=tr.state_bytes(), buffer_bytes=tr.buffer_bytes(),
                               staging_copies=tr.staging_copies, chunk_pages=tr.chunk_pages,
                               sweep_chunks=tr.stats["sweep_chunks"] // OOC_STEPS,
                               sweep_pages=tr.stats["sweep_pages"] // OOC_STEPS,
                               leaves=len(tr.source), launches=launches,
                               copy_variants=copy_variants)
                rec["state"] = tr.state_dict()
                if mode == "paged":
                    # one more step, profiled; then the grad phase's fetch alone
                    _, wall, busy, copies, top = profiled(
                        torch, lambda: tr.step(data[OOC_STEPS]))
                    rec["profiled_step"] = {"wall_ms": wall, "device_busy_ms": busy,
                                            "copy_ms": copies, "top_device_ops": top,
                                            "device_idle_share": 1 - busy / wall,
                                            "kernel_idle_share": 1 - (busy - copies) / wall}
                    tr.source.invalidate()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fetched = [tr.source[i] for i in range(len(tr.source))]
                    torch.cuda.synchronize()
                    fetch_s = time.perf_counter() - t0
                    del fetched
                    rec["grad_fetch"] = {"bytes": pt * OOC_PAGE, "s": fetch_s,
                                         "gb_per_s": pt * OOC_PAGE / fetch_s / 1e9}
                runs[mode] = rec
            finally:
                tr.close()
                del tr
                torch.cuda.empty_cache()
    finally:
        faulthandler.cancel_dump_traceback_later()
    res, pag = runs["resident"], runs["paged"]
    equal = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        tree_flatten(pag["state"])[0], tree_flatten(res["state"])[0]))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    ooc = {"page_bytes": OOC_PAGE, "params_pages": pt, "moments_pages": mt,
           "largest_leaf_pages": largest, "params_buffer_pages": ocfg.params_buffer_pages,
           "moments_buffer_pages": ocfg.moments_buffer_pages, "pool_pages": pt,
           "state_bitwise_equal": equal, "losses_equal": pag["losses"] == res["losses"],
           "step_time_ratio": med(pag["step_s"]) / med(res["step_s"]),
           **{mode: {k: v for k, v in rec.items() if k != "state"}
              for mode, rec in runs.items()}}

    # 4. the resident Trainer against the OOCTrainer, same weights and batches
    tr = Trainer(cfg, TrainerConfig(train=tcfg, total_steps=OOC_STEPS, log_every=1),
                 params=params0, device="cuda")
    tr.fit(batches)
    t_losses = [h["loss"] for h in tr.metrics_log]
    t_params = tree_map(to_numpy, tr.params)
    del tr
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(t_losses, pag["losses"]))
    param_rel = rel_norm(t_params, pag["state"]["params"])
    emit({"phase": "train", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "param_dtype": cfg.param_dtype, "remat": cfg.remat, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "attention": attention, "trainer": resident, "ooc": ooc,
          "trainer_vs_ooc": {"losses": t_losses, "loss_max_rel_diff": loss_rel,
                             "param_rel_norm_diff": param_rel,
                             "params_bitwise_equal": param_rel == 0.0}})
    check(equal and pag["losses"] == res["losses"],
          "train: OOCTrainer paged and resident are not bitwise equal")
    check(pag["staging_copies"] == 0, f"train: {pag['staging_copies']} staging copies")
    want = OOC_STEPS * pag["leaves"]
    for name in ("page_scatter", "page_gather"):
        check(pag["launches"][name] == want,
              f"train: {pag['launches'][name]} {name} launches, {want} expected "
              f"(one per leaf fetched / read)")
        check(pag["copy_variants"][name] == {"bulk": want, "generic": 0},
              f"train: {name} launches by variant {pag['copy_variants'][name]}")
    check(loss_rel <= TRAIN_LOSS_REL_TOL,
          f"train: Trainer and OOCTrainer losses {loss_rel} apart (relative)")
    check(param_rel <= TRAIN_PARAM_REL_TOL,
          f"train: Trainer and OOCTrainer parameters {param_rel} apart (norm-relative)")
    # phase 11 trains from the same start and restores the paged state
    handoff = {"params0": params0, "batches": batches, "tcfg": tcfg, "state": pag["state"]}
    return pag["launches"], pag["copy_variants"], handoff


# ------------------------------------------------------------------ main


# ------------------------------------------------------------------ phase 9


def device_params(torch, cfg, dtype, seed=0):
    """Random weights from ``seed``, made on the card: the port's own
    initialisers (``param_specs``, padded heads' output rows zero) drawing
    from a CUDA generator with the card as the default device.  A full-width
    model's ~10^10 draws take seconds there and minutes on the host."""
    from repro_torch.models.common import init_param_tree
    from repro_torch.models.transformer import param_specs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        return init_param_tree(param_specs(cfg), gen, dtype, "cuda")


class Patched:
    """Replace ``module.<attr>`` by ``wrap(original)`` while active."""

    def __init__(self, module, attr, wrap):
        self.module, self.attr, self.wrap = module, attr, wrap

    def __enter__(self):
        self.original = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self.wrap(self.original))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.original)


def annotated(torch, module, attr, name):
    """``module.<attr>`` inside a ``record_function(name)`` range while
    active, so a profile can sum the kernels launched inside it."""
    def wrap(fn):
        def inner(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return inner
    return Patched(module, attr, wrap)


def zoo_requests(cfg, Request, spec, seed=0):
    """The phase's traffic for one model: ``spec["lens"]`` prompts (numpy
    ``seed`` tokens) x ZOO_NEW_TOKENS, and a request of the registered
    prefix + 1 token, whose first decode write copies a shared page."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, max_new_tokens=ZOO_NEW_TOKENS, deadline_s=900.0,
                    prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32))
            for i, n in enumerate(spec["lens"])]
    prefix = rng.integers(0, cfg.vocab_size, size=spec["prefix"]).astype(np.int32)
    cow = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=1)]).astype(np.int32)
    reqs.append(Request(rid=len(reqs), max_new_tokens=ZOO_NEW_TOKENS, deadline_s=900.0,
                        prompt=cow))
    return reqs, prefix


def zoo_fp32_check(torch, M, cfg, spec):
    """An fp32 engine with one lane and a bucket of 1 (so an MoE dispatch
    sees the tokens unbatched decode does): its greedy tokens must equal
    the port's contiguous decode of the prompt alone.  Returns (the fp32
    weights, the check's numbers)."""
    import numpy as np

    from repro_torch.serve.engine import EngineConfig, Request

    layers, n = spec["fp32"]
    cfg32 = cfg.replace(compute_dtype="float32",
                        **({} if layers is None else {"num_layers": layers}))
    params = device_params(torch, cfg32, torch.float32)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=n).astype(np.int32)
    req = Request(rid=0, max_new_tokens=8, deadline_s=900.0, prompt=prompt)
    pages = -(-(n + cfg.num_meta_tokens + 9) // 16) + 2
    serve_timed(torch, cfg32, params, EngineConfig(
        max_batch=1, page_size=16, num_pages=pages + 1, max_pages_per_seq=pages,
        prefill_bucket=1), [req])
    ref, _ = contiguous_decode(torch, M, cfg32, params, prompt, 8)
    check(ref == req.generated,
          f"{cfg.name} fp32 ({cfg32.num_layers} layers): engine {req.generated} != "
          f"contiguous decode {ref}")
    return params, {"layers": cfg32.num_layers, "prompt_tokens": n,
                    "tokens_equal": len(ref), "window": cfg.sliding_window}


def zoo_bf16_check(torch, M, cfg, params, eng):
    """Each bf16 token of the shortest request within tolerance of the
    maximum logit of a teacher-forced contiguous decode (plain attention
    route, explicit positions)."""
    short = min(eng.finished, key=lambda r: len(r.prompt))
    _, logits = contiguous_decode(torch, M, cfg, eng.params, short.prompt, len(short.generated),
                                  forced=short.generated, plain=True)
    tol = TOL["bfloat16"]
    gaps = []
    for step, (lg, tok) in enumerate(zip(logits, short.generated)):
        check(bool(torch.isfinite(lg).all()), f"{cfg.name}: non-finite logits")
        top = lg.max()
        gap = (top - lg[tok]).item()
        gaps.append(gap)
        check(gap <= tol["atol"] + tol["rtol"] * abs(top.item()),
              f"{cfg.name} bf16 step {step}: token {tok} is {gap} below the contiguous max")
    return {"prompt_tokens": len(short.prompt), "max_gap_to_top_logit": max(gaps),
            "tokens_equal_to_contiguous_argmax": sum(g == 0.0 for g in gaps)}


def zoo_model(torch, M, K, arch, spec):
    """One model of phase 9: the fp32 check, then the bf16 traffic through
    a fresh engine with the launch counts zeroed just before and read just
    after, a profiled decode step with 4 live lanes, and the bf16 check.
    Returns the launch counts, with ``paged_attention_windowed`` the
    windowed share of paged_attention's."""
    import repro_torch.models.blocks as blocks_module
    import repro_torch.models.moe as moe_module
    import repro_torch.models.ssm as ssm_module
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.page_gather import kernel as CK
    from repro_torch.kernels.paged_attention import ops as attn_ops
    from repro_torch.models.transformer import cast_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    full = get_config(arch)
    cfg = full if spec["layers"] is None else full.replace(num_layers=spec["layers"])
    t0 = time.perf_counter()
    fp32 = None
    params = None
    if spec["fp32"]:
        p32, fp32 = zoo_fp32_check(torch, M, cfg, spec)
        if spec["fp32"][0] is None:                    # the whole model: keep its weights
            params = cast_params(cfg, p32)
        del p32
        torch.cuda.empty_cache()
    if params is None:
        params = device_params(torch, cfg, torch.bfloat16)
    setup_s = time.perf_counter() - t0
    ecfg = EngineConfig(max_batch=4, page_size=16, num_pages=spec["pages"],
                        max_pages_per_seq=spec["pps"], prefill_bucket=32)
    warm, _ = zoo_requests(cfg, Request, dict(spec, lens=[200], prefix=8), seed=1)
    for r in warm:
        r.max_new_tokens = 2
    serve_timed(torch, cfg, params, ecfg, warm)          # cuBLAS, allocator

    reqs, prefix = zoo_requests(cfg, Request, spec)
    windowed = {"window": 0, "none": 0}
    drops = {"prefill": [], "decode": []}

    def count_windows(fn):
        def inner(*args, window=None, **kw):
            windowed["none" if window is None else "window"] += 1
            return fn(*args, window=window, **kw)
        return inner

    def note_drops(fn):
        def inner(p, x, *args, **kw):
            y, aux = fn(p, x, *args, **kw)
            drops["prefill" if x.shape[1] > 1 else "decode"].append(aux["moe_drop_frac"])
            return y, aux
        return inner

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    CK.reset_copy_variant_counts()
    with Patched(attn_ops, "_cuda", count_windows), \
            Patched(blocks_module, "moe_forward", note_drops):
        eng, seconds = serve_timed(torch, cfg, params, ecfg, reqs, prefix=prefix)
    launches = dict(K.launch_counts)
    variants = dict(FK.variant_counts)
    copy_variants = copy_variants_now()
    peak = torch.cuda.max_memory_allocated()
    done = sorted(eng.finished, key=lambda r: r.rid)
    tokens = sum(len(r.generated) for r in done)
    prefill_s = sum(r.prefill_ms for r in done) / 1e3
    for name, n in launches.items():
        check(n > 0, f"{arch}: kernel {name} was not launched")
    check(windowed["window"] + windowed["none"] == launches["paged_attention"],
          f"{arch}: paged_attention calls {windowed} != launches {launches['paged_attention']}")
    if cfg.sliding_window:
        check(windowed["window"] > 0, f"{arch}: no windowed paged_attention launch")
    if cfg.global_layers:
        check(windowed["none"] > 0, f"{arch}: no paged_attention launch of a global layer")
    check(variants == {"hopper": launches["flash_attention"], "generic": 0},
          f"{arch}: flash_attention launches by variant {variants}, all should be hopper")
    check(eng.stats["cow_copies"] > 0 and eng.stats["prefix_hits"] > 0,
          f"{arch}: the prefix request did not share pages / copy on write")
    row = {"phase": "zoo", "arch": arch, "dtype": cfg.compute_dtype,
           "layers": cfg.num_layers, "of_layers": full.num_layers,
           "window": cfg.sliding_window, "global_layers": list(cfg.global_layers),
           "meta_tokens": cfg.num_meta_tokens, "experts": cfg.num_experts,
           "setup_s": setup_s, "prompt_tokens": [len(r.prompt) for r in reqs],
           "requests_served": len(done), "tokens": tokens, "seconds": seconds,
           "prefill_ms": [[len(r.prompt) - 1, r.prefill_ms] for r in done],
           "prefill_share": prefill_s / seconds,
           "decode_tok_per_s": tokens / (seconds - prefill_s),
           "steps": eng.stats["steps"], "peak_pages_used": eng.stats["peak_pages_used"],
           "prefix_hits": eng.stats["prefix_hits"], "cow_copies": eng.stats["cow_copies"],
           "peak_memory_bytes": peak, "launches": launches,
           "paged_attention_calls": windowed, "flash_attention_variants": variants,
           "copy_variants": copy_variants,
           "copy_launch_bounds": check_copy_launches("zoo", launches, copy_variants, eng),
           "fp32_check": fp32}
    if cfg.num_experts:
        row["moe_drop_frac"] = {k: (torch.stack(v).float().mean().item() if v else None)
                                for k, v in drops.items()}
    if spec["bf16_check"]:
        row["bf16_check"] = zoo_bf16_check(torch, M, cfg, params, eng)
    emit(row)

    # where a decode step's time goes: 4 live lanes, the 4 longest prompts
    prof_eng = ServeEngine(cfg, params, ecfg, device="cuda")
    lanes = sorted(reqs, key=lambda r: -len(r.prompt))[:4]
    for r in lanes:
        prof_eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=16,
                                deadline_s=900.0))
    for _ in range(2):
        prof_eng.step()
    check(len(prof_eng.active) == 4, f"{arch} decode profile: expected 4 live lanes")
    contexts = [prof_eng.seq_len[r.rid] for r in lanes]
    ranges = ("zoo.moe", "zoo.moe.experts") if cfg.num_experts else ()
    with annotated(torch, blocks_module, "moe_forward", "zoo.moe"), \
            annotated(torch, moe_module, "expert_ffn", "zoo.moe.experts"):
        prof = step_profile(torch, prof_eng, 6, ranges=ranges)
    if cfg.num_experts:
        moe_ms, experts_ms = (prof["ranges_ms_per_step"][k] for k in ranges)
        prof["moe_experts_ms_per_step"] = experts_ms
        prof["moe_dispatch_ms_per_step"] = (None if moe_ms is None or experts_ms is None
                                            else moe_ms - experts_ms)
    emit({"phase": "zoo_decode_profile", "arch": arch, "lanes": 4,
          "contexts_at_start": contexts, **prof})
    if cfg.ssm_state:
        with annotated(torch, ssm_module, "selective_scan", "zoo.ssm.scan"):
            profile_prefill(torch, prof_eng, max(reqs, key=lambda r: len(r.prompt)).prompt[:-1],
                            phase="zoo_prefill_profile", ranges=("zoo.ssm.scan",))
    del eng, prof_eng, params
    torch.cuda.empty_cache()
    return dict(launches, paged_attention_windowed=windowed["window"])


def phase_zoo(torch, M, K):
    """Phase 9: every model of ``ZOO`` in turn, each freed before the next.
    Returns each model's launch counts (``zoo_model``)."""
    launches = {}
    for arch, spec in ZOO.items():
        launches[arch] = zoo_model(torch, M, K, arch, spec)
    return launches


# ----------------------------------------------------------------- phase 10


def logits_close(got, want, tol, top_only=False):
    """(ok, max |err|, ||err|| / ||want||) of two logit rows: each entry
    within atol + rtol |want|; with ``top_only`` (a bf16 row through a
    full-width model, the zoo's bf16 check) ``got``'s argmax within atol +
    rtol |max| of ``want``'s top logit."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = (err.norm() / want.norm()).item()
    if top_only:
        top = want.max()
        ok = (top - want[got.argmax()]).item() <= tol["atol"] + tol["rtol"] * abs(top.item())
    else:
        ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
    return ok, err.max().item(), rel


def top_gaps(torch, logits, tokens):
    """Per position, how far the chosen token's logit lies below the top
    one, and whether it is within the bf16 tolerance of it."""
    tol = TOL["bfloat16"]
    top = logits.max(dim=-1).values
    chosen = logits.gather(-1, tokens[..., None].long())[..., 0]
    gaps = (top - chosen).float()
    ok = bool((gaps <= tol["atol"] + tol["rtol"] * top.abs().float()).all())
    return ok, gaps.max().item(), int((gaps == 0).sum().item())


def count_flash_calls(blocks_module, calls):
    """``blocks.flash_attention`` counting its calls by mask while active."""
    def wrap(fn):
        def inner(q, k, v, causal=True, **kw):
            calls["causal" if causal else "non_causal"] += 1
            return fn(q, k, v, causal=causal, **kw)
        return inner
    return Patched(blocks_module, "flash_attention", wrap)


def reset_counts(torch, K, FK, T):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    T.reset_prefill_routes()


def read_counts(torch, K, FK, T, calls):
    return {"launches": dict(K.launch_counts), "flash_attention_variants": dict(FK.variant_counts),
            "flash_attention_calls": dict(calls), "prefill_routes": dict(T.prefill_routes),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def xlstm_rest(torch, M, K, FK, T, blocks_module):
    """xlstm-1.3b (XLSTM_LAYERS blocks) through ServeEngine: the fp32 check
    (8 of 48 blocks, one lane, bucket 1: engine tokens equal to contiguous
    prefill + decode), then the bf16 traffic with every count zeroed just
    before and read just after, a profiled decode step with 4 live lanes
    and a profiled XLSTM_PROFILE_PROMPT-token prefill of the model's
    repeating unit (8 blocks) with the sLSTM loop's and the mLSTM chunk
    scan's device ms."""
    import numpy as np

    import repro_torch.models.xlstm as xlstm_module
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_config("xlstm-1.3b").replace(num_layers=XLSTM_LAYERS)
    t0 = time.perf_counter()
    layers, n = XLSTM_FP32
    cfg32 = cfg.replace(num_layers=layers, compute_dtype="float32")
    plan = [(seg.kind, seg.count) for seg in cfg32.decoder_plan()]
    check(plan == [("mlstm", 7), ("slstm", 1)], f"xlstm fp32 check: plan {plan}")
    p32 = device_params(torch, cfg32, torch.float32)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=n).astype(np.int32)
    req = Request(rid=0, max_new_tokens=8, deadline_s=900.0, prompt=prompt)
    pages = -(-(n + 9) // 16) + 2
    serve_timed(torch, cfg32, p32, EngineConfig(
        max_batch=1, page_size=16, num_pages=pages + 1, max_pages_per_seq=pages,
        prefill_bucket=1), [req])
    ref, _ = contiguous_decode(torch, M, cfg32, p32, prompt, 8)
    check(ref == req.generated,
          f"xlstm fp32 ({layers} blocks): engine {req.generated} != contiguous decode {ref}")
    fp32 = {"blocks": layers, "plan": plan, "prompt_tokens": n, "tokens_equal": len(ref)}
    del p32
    torch.cuda.empty_cache()

    params = device_params(torch, cfg, torch.bfloat16)
    setup_s = time.perf_counter() - t0
    ecfg = EngineConfig(max_batch=4, page_size=16, num_pages=400, max_pages_per_seq=136,
                        prefill_bucket=32)
    rng = np.random.default_rng(0)
    serve_timed(torch, cfg, params, ecfg, [Request(              # cuBLAS, allocator
        rid=0, max_new_tokens=2, deadline_s=900.0,
        prompt=rng.integers(0, cfg.vocab_size, size=200).astype(np.int32))])
    reqs = [Request(rid=i, max_new_tokens=ZOO_NEW_TOKENS, deadline_s=900.0,
                    prompt=rng.integers(0, cfg.vocab_size, size=k).astype(np.int32))
            for i, k in enumerate(XLSTM_LENS)]
    calls = {"causal": 0, "non_causal": 0}
    reset_counts(torch, K, FK, T)
    with count_flash_calls(blocks_module, calls):
        eng, seconds = serve_timed(torch, cfg, params, ecfg, reqs)
    counts = read_counts(torch, K, FK, T, calls)
    check(not any(counts["launches"].values()),
          f"xlstm: no kernel of the port is on its path, yet {counts['launches']}")
    done = sorted(eng.finished, key=lambda r: r.rid)
    tokens = sum(len(r.generated) for r in done)
    prefill_s = sum(r.prefill_ms for r in done) / 1e3
    emit({"phase": "zoo_rest", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "layers": cfg.num_layers, "of_layers": get_config("xlstm-1.3b").num_layers,
          "plan": [(seg.kind, seg.count) for seg in cfg.decoder_plan()],
          "setup_s": setup_s, "prompt_tokens": [len(r.prompt) for r in reqs],
          "requests_served": len(done), "tokens": tokens, "seconds": seconds,
          "prefill_ms": [[len(r.prompt) - 1, r.prefill_ms] for r in done],
          "prefill_share": prefill_s / seconds,
          "decode_tok_per_s": tokens / (seconds - prefill_s), "steps": eng.stats["steps"],
          **counts, "fp32_check": fp32,
          "bf16_check": zoo_bf16_check(torch, M, cfg, params, eng)})

    prof_eng = ServeEngine(cfg, params, ecfg, device="cuda")
    for r in reqs:
        prof_eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=16,
                                deadline_s=900.0))
    for _ in range(2):
        prof_eng.step()
    check(len(prof_eng.active) == 4, "xlstm decode profile: expected 4 live lanes")
    contexts = [prof_eng.seq_len[r.rid] for r in reqs]
    emit({"phase": "zoo_rest_decode_profile", "arch": cfg.name, "lanes": 4,
          "contexts_at_start": contexts, **step_profile(torch, prof_eng, 6)})
    # the prefill's shares on the model's repeating unit, its first 8
    # blocks (7 mLSTM, 1 sLSTM: the 48 blocks are 6 of them, so the shares
    # are the whole model's), a sixth of the profiler's events
    unit = cfg.replace(num_layers=cfg.slstm_every)
    unit_eng = ServeEngine(unit, dict(params, segments=params["segments"][:2]), ecfg,
                           device="cuda")
    ranges = ("xlstm.slstm_scan", "xlstm.mlstm_chunked")
    t1 = time.perf_counter()
    with annotated(torch, xlstm_module, "slstm_scan", ranges[0]), \
            annotated(torch, xlstm_module, "mlstm_chunked", ranges[1]):
        prompt = next(r.prompt for r in reqs if len(r.prompt) == XLSTM_PROFILE_PROMPT)
        profile_prefill(torch, unit_eng, prompt[:-1], phase="zoo_rest_prefill_profile",
                        ranges=ranges)
    emit({"phase": "zoo_rest_prefill_profile_seconds", "arch": cfg.name,
          "blocks": unit.num_layers, "seconds": time.perf_counter() - t1})
    del eng, prof_eng, unit_eng, params
    torch.cuda.empty_cache()
    return counts


def vlm_positions(kind):
    """[1, 3, VLM_PROMPT] int32 positions: ``index`` — all three rows
    0..S-1; ``image`` — VLM_TEXT text tokens, a VLM_GRID x VLM_GRID image
    block (temporal position constant, height and width the grid), and
    VLM_TEXT text tokens continuing past the block's largest position
    (Qwen2-VL's position rule)."""
    import numpy as np

    if kind == "index":
        return np.broadcast_to(np.arange(VLM_PROMPT, dtype=np.int32), (1, 3, VLM_PROMPT)).copy()
    t0 = VLM_TEXT
    hh, ww = np.meshgrid(np.arange(VLM_GRID), np.arange(VLM_GRID), indexing="ij")
    block = np.stack([np.full(VLM_GRID * VLM_GRID, t0), t0 + hh.ravel(), t0 + ww.ravel()])
    start = t0 + VLM_GRID
    pos = np.concatenate([np.tile(np.arange(VLM_TEXT), (3, 1)), block,
                          np.tile(np.arange(start, start + VLM_TEXT), (3, 1))], axis=1)
    check(pos.shape[1] == VLM_PROMPT, f"image prompt of {pos.shape[1]} positions")
    return pos[None].astype(np.int32)


def vlm_generate(torch, M, T, cfg, params, embeds, pos, n_new):
    """``prefill`` on patch embeddings (host-built positions), then greedy
    text ``decode_step``s through the contiguous cache: the first token
    from the prefill's last hidden, the rest from decode.  Returns (tokens,
    the first decode step's logits, prefill ms, decode s, route)."""
    T.reset_prefill_routes()
    cache = M.init_cache(cfg, 1, VLM_PROMPT + n_new + 8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h, cache = M.prefill(cfg, params, {"embeds": embeds, "positions": torch.from_numpy(pos)},
                         cache)
    tok = T.lm_logits(cfg, params, h)[:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    route = [k for k, v in T.prefill_routes.items() if v]
    cur = torch.full((1,), int(pos.max()) + 1, dtype=torch.int32, device="cuda")
    toks, first = [tok], None
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, cur)
        if first is None:
            first = logits[0, :cfg.vocab_size]
        tok = logits[:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
        toks.append(tok)
        cur = cur + 1
    torch.cuda.synchronize()
    return (torch.cat(toks).tolist(), first, prefill_ms, time.perf_counter() - t0,
            route[0] if len(route) == 1 else route)


def vlm_full_logits(torch, M, T, cfg, params, embeds, pos, tok):
    """``forward_train`` over the prompt and the first text token: the
    logits of its last position (what the first decode step predicts)."""
    import numpy as np

    e = T.embed_tokens(cfg, T.cast_params(cfg, params),
                       torch.tensor([[tok]], dtype=torch.int32, device="cuda"))
    full = torch.cat([embeds.to(e.dtype), e], dim=1)
    fpos = np.concatenate([pos, np.full((1, 3, 1), pos.max() + 1, np.int32)], axis=2)
    hid, _ = M.forward_train(cfg, params, {"embeds": full, "positions": torch.from_numpy(fpos)})
    return T.lm_logits(cfg, params, hid[:, -1])[0, :cfg.vocab_size]


def vlm_rest(torch, M, K, FK, T, blocks_module):
    """qwen2-vl-7b through prefill / decode_step: the fp32 check at 2 of 28
    layers for both prompts (the first decode step's logits against
    forward_train over prompt + token, rtol 2e-3 / atol 2e-4), then at full
    width in bf16 the kernel-route prompt and the image-block prompt, each
    x VLM_NEW text tokens, counts zeroed just before and read just after;
    in bf16 the decode step's argmax within 3e-2 of the full forward's top
    logit, the row's errors reported."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen2-vl-7b")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds = torch.randn((1, VLM_PROMPT, cfg.d_model), generator=gen, device="cuda")
    prompts = {"index": vlm_positions("index"), "image": vlm_positions("image")}
    t0 = time.perf_counter()
    cfg32 = cfg.replace(num_layers=VLM_FP32_LAYERS, compute_dtype="float32")
    p32 = device_params(torch, cfg32, torch.float32)
    fp32 = {"layers": VLM_FP32_LAYERS}
    for kind, pos in prompts.items():
        toks, first, _, _, route = vlm_generate(torch, M, T, cfg32, p32, embeds, pos, 2)
        want = vlm_full_logits(torch, M, T, cfg32, p32, embeds, pos, toks[0])
        ok, err, rel = logits_close(first, want, EXTRAS_TOL)
        check(ok, f"qwen2-vl fp32 {kind}: decode logits vs forward_train max |err| {err}")
        fp32[kind] = {"route": route, "max_abs_err": err, "rel_err": rel}
    check(fp32["index"]["route"] == "kernel" and fp32["image"]["route"] == "plain",
          f"qwen2-vl routes {fp32}")
    del p32
    torch.cuda.empty_cache()

    params = device_params(torch, cfg, torch.bfloat16)
    setup_s = time.perf_counter() - t0
    embeds = embeds.to(torch.bfloat16)
    vlm_generate(torch, M, T, cfg, params, embeds[:, :128], prompts["index"][..., :128], 2)
    calls = {"causal": 0, "non_causal": 0}
    out = {}
    reset_counts(torch, K, FK, T)
    routes = {"kernel": 0, "plain": 0}
    with count_flash_calls(blocks_module, calls):
        for kind, pos in prompts.items():
            out[kind] = vlm_generate(torch, M, T, cfg, params, embeds, pos, VLM_NEW)
            for k, v in T.prefill_routes.items():
                routes[k] += v
    counts = read_counts(torch, K, FK, T, calls)
    counts["prefill_routes"] = routes
    fl = counts["launches"]["flash_attention"]
    check(fl == cfg.num_layers, f"qwen2-vl: flash_attention launches {fl} != {cfg.num_layers}")
    check(counts["flash_attention_variants"] == {"hopper": fl, "generic": 0},
          f"qwen2-vl: flash_attention variants {counts['flash_attention_variants']}")
    check(routes == {"kernel": 1, "plain": 1}, f"qwen2-vl prefill routes {routes}")
    rows = {}
    for kind, pos in prompts.items():
        toks, first, prefill_ms, decode_s, route = out[kind]
        want = vlm_full_logits(torch, M, T, cfg, params, embeds, pos, toks[0])
        ok, err, rel = logits_close(first, want, TOL["bfloat16"], top_only=True)
        check(ok, f"qwen2-vl bf16 {kind}: decode logits vs forward_train: max |err| {err}, "
                  f"row relative error {rel}")
        check(all(0 <= t < cfg.vocab_size for t in toks), "qwen2-vl: token outside the vocabulary")
        rows[kind] = {"route": route, "prompt_positions": [int(pos.min()), int(pos.max())],
                      "prefill_ms": prefill_ms, "decode_tok_per_s": (len(toks) - 1) / decode_s,
                      "tokens": len(toks), "check_max_abs_err": err, "check_rel_err": rel,
                      "check_argmax_equal": int(first.argmax()) == int(want.argmax())}
    emit({"phase": "zoo_rest", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "layers": cfg.num_layers, "heads": [cfg.num_heads, cfg.padded_heads, cfg.num_kv_heads],
          "mrope_sections": list(cfg.mrope_sections), "setup_s": setup_s,
          "prompts": rows, **counts, "fp32_check": fp32})
    del params, out
    torch.cuda.empty_cache()
    return counts


def encdec_generate(torch, M, T, cfg, params, src, prompt, n_new):
    """``prefill`` (encoder over the frames, the memory KV into the cache,
    the decoder prompt), then greedy ``decode_step``s: the first token from
    the prefill's last hidden.  Returns (tokens [B, n_new], the first
    decode step's logits, prefill ms, decode s)."""
    b, p = prompt.shape
    cache = M.init_cache(cfg, b, p + n_new + 8, device="cuda", memory_len=src.shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h, cache = M.prefill(cfg, params, {"tokens": prompt, "src_embeds": src}, cache)
    tok = T.lm_logits(cfg, params, h)[:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cur = torch.full((b,), p, dtype=torch.int32, device="cuda")
    toks, first = [tok], None
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, cur)
        if first is None:
            first = logits[:, :cfg.vocab_size]
        tok = logits[:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
        toks.append(tok)
        cur = cur + 1
    torch.cuda.synchronize()
    return torch.stack(toks, dim=1), first, prefill_ms, time.perf_counter() - t0


def encdec_rest(torch, M, K, FK, T, blocks_module):
    """seamless-m4t-medium, nothing cut: the fp32 check at full width (the
    400-frame request: the first decode step's logits against forward_train
    over prompt + token, rtol 2e-3 / atol 2e-4), then in bf16 batch 4 of
    1200 frames and the 400-frame request alone, counts zeroed just before
    and read just after; each bf16 token within tolerance of the top logit
    of a teacher-forced forward_train."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("seamless-m4t-medium")
    gen = torch.Generator(device="cuda").manual_seed(2)
    src = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model), generator=gen, device="cuda")
    alone = torch.randn((1, ENCDEC_ALONE, cfg.d_model), generator=gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    t0 = time.perf_counter()
    cfg32 = cfg.replace(compute_dtype="float32")
    p32 = device_params(torch, cfg32, torch.float32)
    toks, first, _, _ = encdec_generate(torch, M, T, cfg32, p32, alone, prompt[:1], 2)
    full = torch.cat([prompt[:1], toks[:, :1]], dim=1)
    hid, _ = M.forward_train(cfg32, p32, {"tokens": full, "src_embeds": alone})
    ok, err, rel = logits_close(first[0], T.lm_logits(cfg32, p32, hid[:, -1])[0, :cfg.vocab_size],
                                EXTRAS_TOL)
    check(ok, f"seamless fp32: decode logits vs forward_train max |err| {err}")
    fp32 = {"frames": ENCDEC_ALONE, "max_abs_err": err, "rel_err": rel}
    del p32, hid
    torch.cuda.empty_cache()

    params = device_params(torch, cfg, torch.bfloat16)
    setup_s = time.perf_counter() - t0
    src, alone = src.to(torch.bfloat16), alone.to(torch.bfloat16)
    encdec_generate(torch, M, T, cfg, params, src[:, :128], prompt, 2)     # warm-up
    calls = {"causal": 0, "non_causal": 0}
    reset_counts(torch, K, FK, T)
    with count_flash_calls(blocks_module, calls):
        batch = encdec_generate(torch, M, T, cfg, params, src, prompt, ENCDEC_NEW)
        single = encdec_generate(torch, M, T, cfg, params, alone, prompt[:1], ENCDEC_NEW)
    counts = read_counts(torch, K, FK, T, calls)
    fl = counts["launches"]["flash_attention"]
    check(fl == 2 * 3 * cfg.num_layers,
          f"seamless: flash_attention launches {fl} != 2 prefills x 3 x {cfg.num_layers}")
    check(calls == {"causal": 2 * cfg.num_layers, "non_causal": 4 * cfg.num_layers},
          f"seamless: flash_attention calls by mask {calls}")
    check(counts["flash_attention_variants"] == {"hopper": fl, "generic": 0},
          f"seamless: flash_attention variants {counts['flash_attention_variants']}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    T._encode(cfg, T.cast_params(cfg, params), {"src_embeds": src}, "prefill")
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t1) * 1e3
    rows = {}
    for name, (toks, _, prefill_ms, decode_s), mem in (("batch", batch, src),
                                                        ("alone", single, alone)):
        b = toks.shape[0]
        full = torch.cat([prompt[:b], toks[:, :-1]], dim=1)
        hid, _ = M.forward_train(cfg, params, {"tokens": full, "src_embeds": mem})
        logits = T.lm_logits(cfg, params, hid[:, ENCDEC_PROMPT - 1:])[..., :cfg.vocab_size]
        ok, gap, equal = top_gaps(torch, logits, toks)
        check(ok, f"seamless bf16 {name}: a token {gap} below the teacher-forced top logit")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "seamless: token outside the vocabulary")
        rows[name] = {"batch": b, "frames": mem.shape[1], "prompt_tokens": ENCDEC_PROMPT,
                      "prefill_ms": prefill_ms, "tokens": int(toks.numel()),
                      "decode_tok_per_s": b * (toks.shape[1] - 1) / decode_s,
                      "bf16_max_gap_to_top_logit": gap,
                      "bf16_tokens_equal_to_argmax": equal}
        del hid, logits
    emit({"phase": "zoo_rest", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "layers": [cfg.enc_layers, cfg.num_layers], "setup_s": setup_s,
          "encode_ms_batch": encode_ms, "runs": rows, **counts, "fp32_check": fp32})
    del params
    torch.cuda.empty_cache()
    return counts


def phase_zoo_rest(torch, M, K):
    """Phase 10: xlstm-1.3b, qwen2-vl-7b and seamless-m4t-medium in turn,
    each freed before the next.  Returns each model's counts."""
    import repro_torch.models.blocks as blocks_module
    import repro_torch.models.transformer as T
    from repro_torch.kernels.flash_attention import kernel as FK

    out, seconds = {}, {}
    for arch, run in (("xlstm-1.3b", xlstm_rest), ("qwen2-vl-7b", vlm_rest),
                      ("seamless-m4t-medium", encdec_rest)):
        t0 = time.perf_counter()
        out[arch] = run(torch, M, K, FK, T, blocks_module)
        seconds[arch] = time.perf_counter() - t0
    emit({"phase": "zoo_rest_seconds", **seconds})
    return out


# ----------------------------------------------------------------- phase 11


def timed_in_turns(torch, fns: dict, turns: int, prepare=None):
    """Each named call ``turns`` times, the order alternating every turn
    (a, b, b, a, ...); device-synchronised wall ms per call, by name.
    ``prepare[name]``, where given, runs before each of that name's calls,
    off the clock."""
    names, out = list(fns), {n: [] for n in fns}
    for i in range(turns):
        for n in (names if i % 2 == 0 else names[::-1]):
            if prepare and n in prepare:
                prepare[n]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[n]()
            torch.cuda.synchronize()
            out[n].append((time.perf_counter() - t0) * 1e3)
    return out


def start_dry_run():
    """The dry run of every runnable cell on both production meshes, set
    executing on meta in DIST_DRY_WORKERS niced children: (pool, pending
    records).  Phase 11 collects the records, phases 11 and 13 run their
    peak holds' meta cells in the same pool; ``main`` closes it."""
    from repro_torch.configs.registry import runnable_cells
    from repro_torch.launch import dryrun as DR

    pool = DR.account_pool(DIST_DRY_WORKERS, nice=DIST_DRY_NICE)
    cells = [(arch, shape, multi) for arch, shape in runnable_cells() for multi in (False, True)]
    return pool, DR.start_cells(cells, pool)


def dist_dry_run(pending):
    """(a) every runnable cell on both production meshes, executed on meta
    (rank 0's program under a fake process group of the mesh): each record
    ok; per record the per-device peak, flops, collective bytes, whether the
    peak fits and the meta run's seconds; the sweep's seconds, the wait for
    it here and how many of the 66 fit."""
    import contextlib
    import io

    from repro_torch.launch.dryrun import finish_cells

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        recs = finish_cells(pending, ROOT / "build" / "dryrun")
    waited = time.perf_counter() - t0
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}: {r.get('error')}" for r in recs if not r["ok"]]
    check(len(recs) == DIST_DRY_RECORDS and not bad, f"dry run: {len(recs)} records, failed {bad}")
    return {"records": len(recs), "sweep_seconds": pending.seconds, "waited_s": waited,
            "workers": DIST_DRY_WORKERS, "cpu_seconds": sum(r["run_s"] for r in recs),
            "hbm_bytes": recs[0]["hbm_bytes"], "fit": sum(r["fits"] for r in recs),
            "fit_by_arguments": sum(r["memory"]["argument_bytes"] <= r["hbm_bytes"]
                                    for r in recs),
            "per_record": {f"{r['arch']}/{r['shape']}/{r['mesh']}": {
                "peak_bytes": r["memory"]["peak_bytes"], "flops": r["flops"],
                "collectives_total": r["collectives"]["total"], "fits": r["fits"],
                "run_s": r["run_s"], "argument_bytes": r["memory"]["argument_bytes"]}
                for r in recs}}


def peak_base(torch) -> int:
    """Start measuring a cell call's peak on the card (off the clock): the
    garbage of earlier calls collected — tensors that reference cycles hold
    (the ZeRO-1 gather's DTensors) would otherwise be freed by a collection
    inside the call and taken off its rise —, the peak reset; returns
    ``memory_allocated()``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_since(torch, base, args) -> int:
    """The call's peak since ``peak_base``: the rise of
    ``max_memory_allocated()`` over ``base``, plus the arguments' bytes,
    which the dry run's ``peak_bytes`` counts."""
    from repro_torch.launch.accounting import nbytes

    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base + nbytes(list(args))


def meta_peaks(pool, jobs) -> list:
    """The dry run's ``peak_bytes`` of each ``(cfg, shape, mesh shape, axis
    names, tcfg)`` cell, executed on meta in ``pool``'s children."""
    from repro_torch.launch.dryrun import account_cells

    res = account_cells(jobs, pool=pool)
    for r in res:
        check("error" not in r, f"peak hold: the meta run failed: {r.get('traceback')}")
    return [r["peak_bytes"] for r in res]


def peak_hold(name, measured, meta) -> dict:
    """The card's peak against the meta run's, held within
    DIST_PEAK_REL_TOL; the ratio reported either way."""
    ratio = measured / meta
    check(abs(ratio - 1) <= DIST_PEAK_REL_TOL,
          f"{name}: the card's peak {measured} B is {ratio:.4f} of the dry run's {meta} B")
    return {"card_peak_bytes": measured, "meta_peak_bytes": meta, "ratio": ratio}


def dist_train(torch, mesh, handoff):
    """(b) the data-parallel ZeRO-1 train cell at world size 1 against
    ``train_step`` from phase 8's weights and batches, a step of each in
    turns; losses, params, m and v bitwise equal.  Returns the report and
    the gradient tree of the first batch (for (c))."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import from_numpy, tree_flatten, tree_map
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.train_step import step_grads, train_step

    cfg, tcfg = get_config("smollm-135m"), handoff["tcfg"]
    with use_mesh(mesh, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("train_2k", TRAIN_SEQ, TRAIN_BATCH, "train"),
                             mesh, tcfg)
    batches = [{k: from_numpy(v, "cuda") for k, v in b.items()} for b in handoff["batches"]]
    ref = {"params": tree_map(lambda a: from_numpy(a, "cuda"), handoff["params0"])}
    ref["state"] = init_state(ref["params"])
    run = {"params": tree_map(torch.clone, ref["params"])}
    run["state"] = SP.local_tree(init_state(run["params"]), cell.in_specs[1], mesh)
    grads = step_grads(cfg, tcfg, ref["params"], batches[0])[1]
    losses = {"train_step": [], "cell": []}
    ref_batches = iter(batches)
    cell_batches = iter([SP.local_tree(b, {k: cell.in_specs[2][k] for k in b}, mesh)
                         for b in batches])

    def ref_step():
        ref["params"], ref["state"], m = train_step(cfg, tcfg, ref["params"], ref["state"],
                                                    next(ref_batches))
        losses["train_step"].append(m["loss"].item())

    def cell_step():
        args = (run["params"], run["state"], next(cell_batches))
        run["params"], run["state"], m = cell.fn(*args)
        peak["card"] = peak_since(torch, peak["base"], args)
        del args
        losses["cell"].append(m["loss"].item())

    peak = {}
    ms = timed_in_turns(torch, {"train_step": ref_step, "cell": cell_step}, len(batches),
                        prepare={"cell": lambda: peak.update(base=peak_base(torch))})
    for name, a, b in (("params", run["params"], ref["params"]),
                       ("m", run["state"].m, ref["state"].m),
                       ("v", run["state"].v, ref["state"].v)):
        equal = all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))
        check(equal, f"distributed train: {name} not bitwise train_step's")
    check(losses["cell"] == losses["train_step"], f"distributed train: losses {losses}")
    check(int(run["state"].step) == len(batches), "distributed train: step counter")
    return {"steps": len(batches), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "losses": losses["cell"], "bitwise_equal": True, "step_ms": ms,
            "card_peak_bytes": peak["card"],
            "note": "the first pair warms both paths; the peak is the last cell call's"}, grads


def dist_compressed(torch, group, grads):
    """(c) ``compressed_all_reduce`` on the gradient tree: ms and bytes
    beside a plain fp32 ``all_reduce`` of the same tree; at world size 1 the
    mean is each leaf's own dequantized value, bitwise."""
    from repro_torch.distributed.collectives import compressed_all_reduce, quantize_int8
    from repro_torch.interop import tree_flatten

    import torch.distributed as dist

    leaves = tree_flatten(grads)[0]
    errs = [torch.zeros_like(g, dtype=torch.float32) for g in leaves]
    out = {}

    def compressed():
        out["c"] = [compressed_all_reduce(g, group, e) for g, e in zip(leaves, errs)]

    def plain():
        bufs = [g.float().clone() for g in leaves]
        for b in bufs:
            dist.all_reduce(b, group=group)

    ms = timed_in_turns(torch, {"compressed": compressed, "fp32_all_reduce": plain}, 6)
    for g, e, (mean, new_err) in zip(leaves, errs, out["c"]):
        q, scale, want_err = quantize_int8(g, e)
        check(torch.equal(mean, q.float() * scale) and torch.equal(new_err, want_err),
              "compressed_all_reduce: not the dequantized value at world size 1")
    n = sum(g.numel() for g in leaves)
    return {"leaves": len(leaves), "elements": n, "int8_payload_bytes": n + 4 * len(leaves),
            "fp32_payload_bytes": 4 * n, "ms": ms, "note": "the first turn warms both"}


def dist_moe(torch, mesh, flush):
    """(d) shard-local MoE, TP at mixtral-8x7b's widths and EP at
    phi3.5-moe's, on DIST_MOE_TOKENS tokens: fp32 within 1e-5 of the dense
    dispatch and bf16 within 3e-2 (row norm) of bf16 dense; both timed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models.common import init_param_tree
    from repro_torch.models.moe import _moe_forward_dense, moe_forward, moe_param_specs

    rows = {}
    for arch in DIST_MOE_ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.device("cuda"):
            p32 = init_param_tree(moe_param_specs(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                                  cfg.moe_sharding), gen, torch.float32, "cuda")
            x32 = torch.randn(DIST_MOE_TOKENS + (cfg.d_model,), generator=gen)
        row = {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "experts": cfg.num_experts,
               "top_k": cfg.top_k, "sharding": cfg.moe_sharding,
               "capacity_factor": cfg.capacity_factor, "tokens": list(DIST_MOE_TOKENS)}
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            p = {k: v.to(dt) for k, v in p32.items()}
            x = x32.to(dt)

            def local(p=p, x=x):
                with use_mesh(mesh):
                    return moe_forward(p, x, cfg.top_k, cfg.capacity_factor, shard_local=True,
                                       moe_sharding=cfg.moe_sharding)

            def dense(p=p, x=x):
                return _moe_forward_dense(p, x, cfg.top_k, cfg.capacity_factor)

            (y, aux), (y_ref, aux_ref) = local(), dense()
            if dtype == "float32":
                err = (y - y_ref).abs().max().item()
                check(torch.allclose(y, y_ref, atol=1e-5, rtol=1e-5),
                      f"{arch} shard-local MoE fp32: {err} from dense")
            else:
                err = max_row_rel_err(y, y_ref, f"{arch} shard-local MoE bf16")
                check(err <= 3e-2, f"{arch} shard-local MoE bf16: row error {err}")
            local_ms, _ = time_ms(torch, local, flush, reps=10, warmup=2)
            dense_ms, _ = time_ms(torch, dense, flush, reps=10, warmup=2)
            row[dtype] = {"max_err" if dtype == "float32" else "max_row_rel_err": err,
                          "shard_local_ms": local_ms, "dense_ms": dense_ms,
                          "drop_frac": float(aux["moe_drop_frac"])}
            del p, x, y, y_ref
        rows[arch] = row
        del p32, x32
        torch.cuda.empty_cache()
    return rows


def dist_elastic(torch, mesh, state):
    """(e) phase 8's paged ``OOCTrainer`` state saved to a
    ``HostArrayStore`` and restored onto the mesh through one batched read;
    every local shard bitwise equal to the saved leaf."""
    import numpy as np

    from repro_torch.ckpt.checkpoint import save_tree_to_store
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HostArrayStore
    from repro_torch.distributed.elastic import restore_train_state_elastic
    from repro_torch.interop import to_numpy, tree_flatten, tree_map

    nbytes = sum(np.asarray(a).nbytes for a in tree_flatten(state)[0])
    store = HostArrayStore(np.zeros(nbytes + 4096, np.uint8))
    t0 = time.perf_counter()
    manifest = save_tree_to_store(store, state)
    save_s = time.perf_counter() - t0
    store.reset_stats()
    like = tree_map(lambda a: np.zeros_like(np.asarray(a)), state)
    t0 = time.perf_counter()
    restored, report = restore_train_state_elastic(get_config("smollm-135m"), mesh, store,
                                                   manifest, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(store.num_reads == 1, f"elastic restore: {store.num_reads} store reads, one expected")
    placed = {"params": restored["params"], "m": restored["opt"]["m"],
              "v": restored["opt"]["v"]}
    saved = {"params": state["params"], "m": state["opt"]["m"], "v": state["opt"]["v"]}
    leaves = 0
    for a, b in zip(tree_flatten(placed)[0], tree_flatten(saved)[0]):
        local = a.to_local()
        check(local.device.type == "cuda", "elastic restore: a shard off the card")
        check(np.array_equal(to_numpy(local), np.asarray(b)),
              "elastic restore: a local shard differs from the saved leaf")
        leaves += 1
    return {"bytes": nbytes, "leaves": leaves, "store_reads": store.num_reads,
            "save_s": save_s, "restore_s": restore_s, "devices": report.devices,
            "replicated_leaves": report.replicated_leaves,
            "sharded_leaves": report.sharded_leaves}


def dist_prefill(torch, K, FK, mesh):
    """(f) the prefill cell of full-width qwen2-1.5b on the mesh, counts
    zeroed just before and read just after: logits bitwise ``T.prefill``'s,
    every flash_attention launch on the Hopper variant."""
    import numpy as np

    import repro_torch.models.transformer as T
    from repro_torch import torch_dtype
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for

    cfg = get_config("qwen2-1.5b")
    params = device_params(torch, cfg, torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, DIST_PREFILL, dtype=np.int64).astype(np.int32)).to("cuda")
    shape = ShapeConfig("prefill_1k", DIST_PREFILL[1], DIST_PREFILL[0], "prefill")
    with use_mesh(mesh, rules_for("prefill", cfg)):
        cell = SP.build_cell(cfg, shape, mesh)
    local = SP.local_tree({"tokens": tokens}, cell.in_specs[1], mesh)
    cell.fn(params, local)                                       # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    base = peak_base(torch)
    t0 = time.perf_counter()
    logits, _ = cell.fn(params, local)
    card_peak = peak_since(torch, base, (params, local))
    cell_ms = (time.perf_counter() - t0) * 1e3
    launches, variants = dict(K.launch_counts), dict(FK.variant_counts)
    cache = T.init_cache(cfg, DIST_PREFILL[0], DIST_PREFILL[1], torch_dtype(cfg.compute_dtype),
                         device="cuda")
    hidden, _ = T.prefill(cfg, params, {"tokens": tokens}, cache)
    want = T.lm_logits(cfg, params, hidden)
    check(torch.equal(logits, want), "distributed prefill: logits not bitwise T.prefill's")
    check(bool(torch.isfinite(logits).all()), "distributed prefill: non-finite logits")
    n = launches["flash_attention"]
    check(n == cfg.num_layers and variants == {"hopper": n, "generic": 0},
          f"distributed prefill: flash_attention launches {n}, variants {variants}")
    del params, cache, hidden
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "batch": DIST_PREFILL[0], "prompt_tokens": DIST_PREFILL[1],
            "cell_ms": cell_ms, "logits_bitwise_equal": True, "launches": launches,
            "flash_attention_variants": variants, "card_peak_bytes": card_peak}, logits


def phase_distributed(torch, K, FK, handoff, dry):
    """Phase 11: the distribution slice under NCCL at world size 1 (a file
    store under build/), on a (1, 1) ``(data, model)`` DeviceMesh; ``dry``
    is ``start_dry_run()``'s.  The card's peaks of the train and prefill
    cells are held to the dry run's meta runs of the same cells at (1, 1).
    Returns the prefill cell's kernel launches and its logits (for phase
    12)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import init_process_group

    t_phase = time.perf_counter()
    store = ROOT / "build" / "dist" / "pg_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    init_process_group("cuda", f"file://{store}", world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl", f"distributed: backend {dist.get_backend()}")
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        out = {"backend": dist.get_backend(), "nccl_version": list(torch.cuda.nccl.version()),
               "torch": torch.__version__, "mesh": {"data": 1, "model": 1}}
        pool, pending = dry
        out["dry_run"] = dist_dry_run(pending)
        out["train"], grads = dist_train(torch, mesh, handoff)
        out["compressed_all_reduce"] = dist_compressed(torch, mesh.get_group("data"), grads)
        del grads
        torch.cuda.empty_cache()
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        out["moe"] = dist_moe(torch, mesh, flush)
        del flush
        out["elastic"] = dist_elastic(torch, mesh, handoff["state"])
        out["prefill"], logits = dist_prefill(torch, K, FK, mesh)
        one = ((1, 1), ("data", "model"))
        meta = meta_peaks(pool, [
            (get_config("smollm-135m"), ShapeConfig("train_2k", TRAIN_SEQ, TRAIN_BATCH, "train"),
             *one, handoff["tcfg"]),
            (get_config("qwen2-1.5b"), ShapeConfig("prefill_1k", DIST_PREFILL[1],
                                                   DIST_PREFILL[0], "prefill"), *one, None)])
        out["peak_holds"] = {
            "train": peak_hold("distributed train", out["train"]["card_peak_bytes"], meta[0]),
            "prefill": peak_hold("distributed prefill", out["prefill"]["card_peak_bytes"],
                                 meta[1])}
        out["seconds"] = time.perf_counter() - t_phase
        emit({"phase": "distributed", **out})
    finally:
        dist.destroy_process_group()
    return out["prefill"]["launches"], logits


# ------------------------------------------------------------------ phase 12


def tp_flash_cases(torch, flush, cases=TP_FLASH_CASES):
    """(a) ``flash_attention`` on a tensor-parallel rank's heads
    (``head_offset``) at full width, bf16: each rank's shard of ``cases``
    on both variants bitwise those heads of the launch over every head and
    held to its plain version (TOL, ROW_REL_TOL); the ``timed`` shard timed
    as phase 2 times, beside the full launch.  A case is (B, H, real heads,
    KVH, Sq, D, ranks, timed offset, window), causal over Sq = Sk, or with
    (causal, Sk) after it."""
    import numpy as np

    from repro_torch.kernels.flash_attention.kernel import (VARIANTS, choose_variant,
                                                            flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(12)
    rows = []
    for case, (B, H, NH, KVH, S, D, ranks, timed, window, *mask) in cases.items():
        causal, SK = mask if mask else (True, S)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   .to("cuda", torch.bfloat16).transpose(1, 2)
                   for shape in ((B, S, H, D), (B, SK, KVH, D), (B, SK, KVH, D)))
        per, rep = H // ranks, NH // KVH
        kw = dict(causal=causal, window=window, num_heads=NH)
        full = {var: flash_attention(q, k, v, variant=var, **kw) for var in VARIANTS}
        checked = {}
        for r in range(ranks):
            h0 = r * per
            qs = q[:, h0:h0 + per]
            ref = flash_attention_ref(qs, k, v, head_offset=h0, **kw)
            real = min(max(NH - h0, 0), per)
            for var in VARIANTS:
                out = flash_attention(qs, k, v, variant=var, head_offset=h0, **kw)
                torch.cuda.synchronize()
                check(torch.equal(out, full[var][:, h0:h0 + per]),
                      f"tensor_parallel {case} {var} offset {h0}: not the full launch's heads")
                err = (out.float() - ref.float()).abs()
                tol = TOL["bfloat16"]
                check(bool((err <= tol["atol"] + tol["rtol"] * ref.float().abs()).all()),
                      f"tensor_parallel {case} {var} offset {h0}: max |err| {err.max().item()}")
                row_err = (max_row_rel_err(out[:, :real], ref[:, :real], "flash_attention")
                           if real else 0.0)
                check(row_err <= ROW_REL_TOL["bfloat16"],
                      f"tensor_parallel {case} {var} offset {h0}: row error {row_err}")
                check(bool((out[:, real:] == 0).all()), "tensor_parallel: padded heads not zero")
                checked[(h0, var)] = (err.max().item(), row_err)
                del out, err
            del ref
        qs = q[:, timed:timed + per]
        real = min(max(NH - timed, 0), per)
        variant = choose_variant(qs, k, v)
        check(variant == "hopper", f"tensor_parallel {case}: the shard takes {variant}")
        lo, hi = timed, timed + real                      # global real heads of the shard
        g0, g1 = lo // rep, (hi - 1) // rep + 1           # the KV heads they read
        if lo % rep == 0 and real == (g1 - g0) * rep:     # whole KV groups: the library's GQA
            kl, vl = k[:, g0:g1], v[:, g0:g1]
        else:                                             # a cut group: one KV head a head
            idx = torch.arange(lo, hi, device="cuda") // rep
            kl, vl = k[:, idx], v[:, idx]
        library = sdpa_flash_yardstick(torch, qs, kl, vl, real, causal, window)
        times = measure(torch, flush,
                        lambda: flash_attention(qs, k, v, head_offset=timed, **kw),
                        lambda: flash_attention_ref(qs, k, v, head_offset=timed, **kw), library,
                        {"generic_ms": lambda: flash_attention(qs, k, v, variant="generic",
                                                               head_offset=timed, **kw),
                         "full_launch_ms": lambda: flash_attention(q, k, v, **kw)})
        pairs = visible_pairs(B, S, SK, causal, window)
        nbytes = (B * real * S * D + 2 * B * (g1 - g0) * SK * D + B * per * S * D) * 2
        bnd, by = bound_ms(nbytes, 4.0 * D * real * pairs, "bfloat16")
        err_max, row_err = checked[(timed, "hopper")]
        rows.append(dict(case=case, dtype="bfloat16", q=[B, per, S, D], num_heads=NH, kvh=KVH,
                         window=window, causal=causal, kv_len=SK,
                         ranks=ranks, head_offsets=[r * per for r in range(ranks)],
                         timed_offset=timed, real_heads=real, variant=variant,
                         bitwise_full_launch=True,
                         full_launch_share_ms=times["full_launch_ms"] * real / NH,
                         variant_errors={f"{h0}/{var}": {"max_abs_err": e, "max_row_rel_err": r}
                                         for (h0, var), (e, r) in checked.items()},
                         max_abs_err=err_max, max_row_rel_err=row_err, **times,
                         bound_ms=bnd, bound_by=by))
        del q, k, v, full
        torch.cuda.empty_cache()
    return rows


def whole_cache(torch, cache, specs, mesh):
    """Each cache leaf gathered over ``model`` where its (batch-local)
    spec splits it there: the prefill cache's KV heads, ready to be split
    again by the decode cell's specs."""
    import torch.distributed as dist

    from repro_torch.interop import tree_map
    from repro_torch.models.common import is_tuple

    n = mesh.size(mesh.mesh_dim_names.index("model"))

    def one(t, spec):
        for d, e in enumerate(spec):
            if d != 1 and e == "model" and n > 1:
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t.contiguous(), group=mesh.get_group("model"))
                t = torch.cat(parts, dim=d)
        return t

    return tree_map(one, cache, specs, is_leaf=is_tuple)


def tp_cells(torch, K, FK, mesh, forced=None):
    """qwen2-1.5b's prefill cell at TP_PREFILL then TP_DECODE_STEPS steps of
    its decode cell on ``mesh``, every rank on its own shards (weights from
    seed 0 made on the card, fp32 parameters, bf16 compute, as phase 11).
    The decode feeds ``forced`` tokens where given, else its own greedy
    ones.  Counts zeroed just before the timed prefill (the second) and
    read after the decode; ``flash_attention``'s calls counted by head
    offset.  Returns the report and the logits (prefill, then each step)."""
    import numpy as np

    import repro_torch.models.blocks as blocks
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for

    cfg = get_config("qwen2-1.5b")
    b, prompt = TP_PREFILL
    seq = prompt + TP_DECODE_STEPS
    cells = {}
    for kind in ("prefill", "decode"):
        with use_mesh(mesh, rules_for(kind, cfg)):
            cells[kind] = SP.build_cell(cfg, ShapeConfig(kind, seq, b, kind), mesh)
    full = device_params(torch, cfg, torch.float32)
    params = SP.local_tree(full, cells["prefill"].in_specs[0], mesh)
    del full
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, TP_PREFILL, dtype=np.int64).astype(np.int32)).to("cuda")
    batch = SP.local_tree({"tokens": tokens}, cells["prefill"].in_specs[1], mesh)
    offsets = {}

    def by_offset(fn):
        def inner(*args, head_offset=0, **kw):
            offsets[head_offset] = offsets.get(head_offset, 0) + 1
            return fn(*args, head_offset=head_offset, **kw)
        return inner

    cells["prefill"].fn(params, batch)                            # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    with Patched(blocks, "flash_attention", by_offset):
        t0 = time.perf_counter()
        logits, cache = cells["prefill"].fn(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    out_logits = [logits]
    cache = SP.local_tree(whole_cache(torch, cache, cells["prefill"].out_specs[1], mesh),
                          cells["decode"].in_specs[1], mesh)
    greedy, step_ms = [], []
    nxt = logits.argmax(-1).to(torch.int32)
    for step in range(TP_DECODE_STEPS):
        fed = nxt if forced is None else forced[step].to("cuda")
        cur = torch.full_like(fed, prompt + step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = cells["decode"].fn(params, cache, fed, cur)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out_logits.append(logits)
        greedy.append(fed)
        nxt = logits.argmax(-1).to(torch.int32)
    report = {"arch": cfg.name, "batch": b, "prompt_tokens": prompt,
              "decode_steps": TP_DECODE_STEPS, "prefill_cell_ms": prefill_ms,
              "decode_cell_step_ms": step_ms, "launches": dict(K.launch_counts),
              "flash_attention_variants": dict(FK.variant_counts),
              "flash_attention_calls_by_head_offset": offsets,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del params, cache
    torch.cuda.empty_cache()
    return report, out_logits, torch.stack(greedy)


def tp_rank(rank, world, store, out_dir, forced_path):
    """(c) one of ``world`` gloo ranks sharing the one card: ``tp_cells`` on
    a (1, world) ``(data, model)`` mesh, teacher-forced with (b)'s tokens;
    rank 0 writes the logits, each rank its report."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import kernel as FK

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        forced = torch.from_numpy(np.load(forced_path))
        report, logits, _ = tp_cells(torch, K, FK, mesh, forced)
        report["rank"], report["coordinate"] = rank, list(mesh.get_coordinate())
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
        if rank == 0:
            np.save(Path(out_dir) / "logits.npy",
                    torch.stack([lg.float() for lg in logits]).cpu().numpy())
    finally:
        dist.destroy_process_group()


def logits_row_err(torch, got, want) -> float:
    """Largest ||got - want|| / ||want|| over the rows of ``want``, the
    padded vocabulary (NEG_INF in both) left out."""
    live = want[0] > -1e8
    g, w = got[..., live].float(), want[..., live].float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()


def phase_tensor_parallel(torch, K, FK, prefill_logits):
    """Phase 12: tensor parallelism over ``model``.  (a) ``head_offset`` at
    full width; (b) the TP code path under NCCL at world size 1 (a (1, 1)
    mesh): qwen2-1.5b's prefill cell logits bitwise phase 11 (f)'s and its
    decode cell bitwise ``T.decode_step``, greedy tokens equal; (c) the same
    cells over TP_RANKS gloo ranks on the one card (a (1, 2) mesh: heads,
    KV heads, ffn and vocab split, the decode cache split by sequence),
    within TP_LOGITS_ROW_TOL of (b) and each greedy token within TOL of
    (b)'s top logit; every rank's flash_attention launches hopper, at its
    own head offset.  (c)'s times are gloo's: each collective stages
    through the host, nothing crosses NVLink.  Returns (b)'s launches."""
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    import repro_torch.models.transformer as T
    from repro_torch import torch_dtype
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    t_phase = time.perf_counter()
    out = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out["head_offset"] = tp_flash_cases(torch, flush)
    del flush

    # (b) world size 1 under NCCL
    work = ROOT / "build" / "dist" / "tp"
    work.mkdir(parents=True, exist_ok=True)
    store = work / "nccl_store"
    store.unlink(missing_ok=True)
    init_process_group("cuda", f"file://{store}", world_size=1, rank=0)
    try:
        one, logits1, greedy = tp_cells(torch, K, FK, make_host_mesh("cuda", model=1))
    finally:
        dist.destroy_process_group()
    check(torch.equal(logits1[0], prefill_logits),
          "tensor_parallel (b): prefill logits not bitwise phase 11's")
    cfg = get_config("qwen2-1.5b")
    n = one["launches"]["flash_attention"]
    check(n == cfg.num_layers and one["flash_attention_variants"] == {"hopper": n, "generic": 0}
          and one["flash_attention_calls_by_head_offset"] == {0: n},
          f"tensor_parallel (b): flash_attention {one['flash_attention_variants']}, "
          f"{one['flash_attention_calls_by_head_offset']}")
    params = device_params(torch, cfg, torch.float32)
    b, prompt = TP_PREFILL
    cache = T.init_cache(cfg, b, prompt + TP_DECODE_STEPS, torch_dtype(cfg.compute_dtype),
                         device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, TP_PREFILL, dtype=np.int64).astype(np.int32)).to("cuda")
    hidden, cache = T.prefill(cfg, params, {"tokens": tokens}, cache)
    nxt, bitwise, ref_ms = T.lm_logits(cfg, params, hidden).argmax(-1).to(torch.int32), True, []
    for step in range(TP_DECODE_STEPS):
        check(torch.equal(nxt, greedy[step]), f"tensor_parallel (b): greedy token {step} differs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = T.decode_step(cfg, params, cache, nxt, torch.full_like(nxt, prompt + step))
        torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        bitwise &= torch.equal(lg, logits1[step + 1])
        nxt = lg.argmax(-1).to(torch.int32)
    check(bitwise, "tensor_parallel (b): decode-cell logits not bitwise T.decode_step's")
    one.update(logits_bitwise_phase11=True, greedy_tokens_equal=True,
               decode_logits_bitwise_decode_step=True, decode_step_ms=ref_ms)
    out["world_size_1"] = one
    del params, cache, hidden
    torch.cuda.empty_cache()

    # (c) TP_RANKS gloo ranks on the one card
    store = work / "gloo_store"
    store.unlink(missing_ok=True)
    np.save(work / "forced.npy", greedy.cpu().numpy())
    t0 = time.perf_counter()
    mp.start_processes(tp_rank, args=(TP_RANKS, str(store), str(work), str(work / "forced.npy")),
                       nprocs=TP_RANKS, start_method="spawn", join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TP_RANKS)]
    logits_c = torch.from_numpy(np.load(work / "logits.npy")).to("cuda")
    errs = [logits_row_err(torch, logits_c[i], logits1[i]) for i in range(len(logits1))]
    check(max(errs) <= TP_LOGITS_ROW_TOL, f"tensor_parallel (c): logits row errors {errs}")
    tol, equal = TOL["bfloat16"], 0
    for i in range(len(logits1)):       # the prefill's, then each step's, next tokens
        mine, want = logits_c[i].argmax(-1), logits1[i].float()
        top = want.max(-1).values
        gap = top - want.gather(-1, mine[:, None])[:, 0]
        check(bool((gap <= tol["atol"] + tol["rtol"] * top.abs()).all()),
              f"tensor_parallel (c): token {i} is {gap.max().item()} below the top logit")
        equal += int((mine == want.argmax(-1)).sum())
    per = cfg.padded_heads // TP_RANKS
    for r, rep in enumerate(ranks):
        n = rep["launches"]["flash_attention"]
        check(n == cfg.num_layers and rep["flash_attention_variants"] == {"hopper": n, "generic": 0}
              and rep["flash_attention_calls_by_head_offset"] == {str(r * per): n},
              f"tensor_parallel (c) rank {r}: {rep['flash_attention_variants']}, "
              f"{rep['flash_attention_calls_by_head_offset']}")
    out["gloo_ranks"] = {"ranks": ranks, "wall_s": wall, "logits_row_err": errs,
                         "greedy_tokens_equal": equal,
                         "greedy_tokens": len(logits1) * TP_PREFILL[0],
                         "note": "gloo stages every collective through the host: "
                                 "these times are not NVLink's"}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tensor_parallel", **out})
    return one["launches"], out["head_offset"], [rep["launches"] for rep in ranks]


# ----------------------------------------------------------------- phase 13


def card_name_power() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def tpt_cell_config():
    """Phase 13's (config, train shape, train config)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    return (get_config("qwen2-1.5b").replace(num_layers=TPT_LAYERS),
            ShapeConfig("train_tp", TPT_SEQ, TPT_BATCH, "train"),
            TrainConfig(optimizer=AdamWConfig(learning_rate=TPT_LR, warmup_steps=1)))


def tpt_setup(torch, mesh):
    """Phase 13's config, its train cell on ``mesh`` and the batches."""
    import numpy as np

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for

    cfg, shape, tcfg = tpt_cell_config()
    with use_mesh(mesh, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, shape, mesh, tcfg)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(TPT_STEPS):
        t = rng.integers(0, cfg.vocab_size, (TPT_BATCH, TPT_SEQ + 1),
                         dtype=np.int64).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return cfg, tcfg, cell, batches


def tpt_local(torch, cell, mesh, full):
    """This rank's param shards of the whole ``full`` and its ZeRO-1 moments
    (zeros of the shard's shape: no whole-size moments are made)."""
    from repro_torch.interop import tree_map
    from repro_torch.launch import specs as SP
    from repro_torch.models.common import is_tuple
    from repro_torch.distributed.sharding import shard_slices
    from repro_torch.train.optimizer import AdamWState

    def zeros():
        return tree_map(lambda t, s: torch.zeros_like(t[shard_slices(s, t.shape, mesh)],
                                                      dtype=torch.float32),
                        full, cell.in_specs[1].m, is_leaf=is_tuple)

    step = torch.zeros((), dtype=torch.int32, device="cuda")
    return SP.local_tree(full, cell.in_specs[0], mesh), AdamWState(step, zeros(), zeros())


def tpt_batch(torch, cell, mesh, batch):
    from repro_torch.interop import from_numpy
    from repro_torch.launch import specs as SP

    b = {k: from_numpy(v, "cuda") for k, v in batch.items()}
    return SP.local_tree(b, {k: cell.in_specs[2][k] for k in b}, mesh)


def tpt_process(torch):
    """A spawned process of phase 13 on the card, set as ``main`` sets the
    script's; returns the kernels module (its launch counts)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return K


def tpt_single(_rank, store, work):
    """(a) in a process of its own: the TP train cell under NCCL at world
    size 1 (a (1, 1) mesh) against ``train_step``, a step of each in turns,
    params, m and v bitwise after every step; writes its report and (a)'s m
    after step 1 sliced as each of (b)'s ranks holds it."""
    import torch
    import torch.distributed as dist

    K = tpt_process(torch)
    from repro_torch.distributed.sharding import MeshSpec, shard_slices, use_mesh
    from repro_torch.interop import tree_flatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import init_process_group, make_host_mesh, rules_for
    from repro_torch.models.common import is_tuple
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.train_step import train_step

    work = Path(work)
    init_process_group("cuda", f"file://{store}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh("cuda", model=1)
        cfg, tcfg, cell, batches = tpt_setup(torch, mesh)
        full = device_params(torch, cfg, torch.float32)
        n_params = sum(t.numel() for t in tree_flatten(full)[0])
        run = dict(zip(("params", "state"), tpt_local(torch, cell, mesh, full)))
        ref = {"params": full, "state": init_state(full)}
        del full
        ranks_mesh = MeshSpec(("data", "model"), (1, TPT_RANKS))
        with use_mesh(ranks_mesh, rules_for("train", cfg)):
            m_specs = tree_flatten(SP.opt_pspecs(cfg, ranks_mesh).m, is_tuple)[0]
        losses = {"train_step": [], "cell": []}
        norms = {"train_step": [], "cell": []}
        ms = {"train_step": [], "cell": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        overall = 0
        for i, batch in enumerate(batches):
            feed = tpt_batch(torch, cell, mesh, batch)
            for name in (("train_step", "cell") if i % 2 == 0 else ("cell", "train_step")):
                if name == "cell":
                    overall = max(overall, torch.cuda.max_memory_allocated())
                    base = peak_base(torch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "cell":
                    args = (run["params"], run["state"], feed)
                    run["params"], run["state"], m = cell.fn(*args)
                    card_peak = peak_since(torch, base, args)
                    del args
                else:
                    ref["params"], ref["state"], m = train_step(cfg, tcfg, ref["params"],
                                                                ref["state"], feed)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
                losses[name].append(m["loss"].item())
                norms[name].append(m["grad_norm"].item())
            for what in ("params", "m", "v"):
                a = run["params"] if what == "params" else getattr(run["state"], what)
                b = ref["params"] if what == "params" else getattr(ref["state"], what)
                check(all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0],
                                                            tree_flatten(b)[0])),
                      f"tensor_parallel_train (a): {what} after step {i + 1} not bitwise "
                      "train_step's")
            if i == 0:
                m1 = tree_flatten(run["state"].m)[0]
                for r in range(TPT_RANKS):
                    torch.save([t[shard_slices(s, t.shape, ranks_mesh, (0, r))].cpu()
                                for t, s in zip(m1, m_specs)], work / f"m1_rank{r}.pt")
                del m1
        launches = dict(K.launch_counts)
        check(losses["cell"] == losses["train_step"] and norms["cell"] == norms["train_step"],
              f"tensor_parallel_train (a): losses {losses}, grad norms {norms}")
        check(launches["flash_attention"] == 0,
              f"tensor_parallel_train (a): flash_attention launched {launches}")
        report = {"arch": cfg.name, "layers": cfg.num_layers, "of_layers": 28,
                  "params": n_params, "batch": TPT_BATCH, "seq": TPT_SEQ, "steps": TPT_STEPS,
                  "losses": losses["cell"], "grad_norms": norms["cell"], "step_ms": ms,
                  "bitwise_equal_train_step": True, "launches": launches,
                  "peak_memory_bytes": max(overall, torch.cuda.max_memory_allocated()),
                  "cell_peak_bytes": card_peak,
                  "note": "the first pair warms both paths; (a) holds both training states; "
                          "cell_peak_bytes is the last cell call's"}
        (work / "single.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def tpt_rank(rank, world, store, work):
    """(b) one of ``world`` gloo ranks sharing the one card: the TP train
    cell on a (1, world) ``(data, model)`` mesh from (a)'s weights (seed 0
    on the card) and batches; writes its report, its replicated leaves and
    its m after step 1 held to (a)'s slice (on the host)."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from torch.distributed.device_mesh import init_device_mesh

    K = tpt_process(torch)
    from repro_torch.interop import tree_flatten
    from repro_torch.models.common import is_tuple

    work = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        cfg, tcfg, cell, batches = tpt_setup(torch, mesh)
        full = device_params(torch, cfg, torch.float32)
        params, state = tpt_local(torch, cell, mesh, full)
        del full
        torch.cuda.empty_cache()
        calls = {}

        def counted(op):
            def wrap(fn):
                def inner(*args, group=None, **kw):
                    if dist.get_world_size(group) > 1:
                        t = args[1] if op == "all_gather" else args[0]
                        c = calls.setdefault(op, {"calls": 0, "bytes": 0})
                        c["calls"] += 1
                        c["bytes"] += t.numel() * t.element_size()
                    return fn(*args, group=group, **kw)
                return inner
            return Patched(dist, op, wrap)

        losses, norms, step_ms, m1_err = [], [], [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        overall = 0
        with counted("all_reduce"), counted("all_gather"):
            for i, batch in enumerate(batches):
                feed = tpt_batch(torch, cell, mesh, batch)
                overall = max(overall, torch.cuda.max_memory_allocated())
                base = peak_base(torch)
                t0 = time.perf_counter()
                args = (params, state, feed)
                params, state, m = cell.fn(*args)
                card_peak = peak_since(torch, base, args)
                del args
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
                if i == 0:
                    want = torch.load(work / f"m1_rank{rank}.pt")
                    for j, (got, w) in enumerate(zip(tree_flatten(state.m)[0], want)):
                        check(got.shape == w.shape, f"tensor_parallel_train (b): m{j} shape")
                        m1_err[j] = ((got.cpu() - w).norm() / w.norm().clamp_min(1e-30)).item()
                    del want
        peak = max(overall, torch.cuda.max_memory_allocated())
        split = [any(e is not None for e in s)
                 for s in tree_flatten(cell.in_specs[0], is_tuple)[0]]
        torch.save({name: [t.cpu() for t, sp in zip(tree_flatten(tree)[0], split) if not sp]
                    for name, tree in (("params", params), ("m", state.m), ("v", state.v))},
                   work / f"replicated_rank{rank}.pt")
        worst = max(m1_err, key=m1_err.get)
        report = {"rank": rank, "coordinate": list(mesh.get_coordinate()), "losses": losses,
                  "grad_norms": norms, "step_ms": step_ms,
                  "collectives_per_step": {op: {k: v / TPT_STEPS for k, v in c.items()}
                                           for op, c in calls.items()},
                  "m_step1_max_rel_err": m1_err[worst], "m_step1_worst_leaf": worst,
                  "launches": dict(K.launch_counts), "peak_memory_bytes": peak,
                  "cell_peak_bytes": card_peak,
                  "replicated_leaves": len(split) - sum(split), "split_leaves": sum(split)}
        (work / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def phase_tensor_parallel_train(torch, pool):
    """Phase 13: the train cell tensor-parallel over ``model`` on full-width
    qwen2-1.5b at TPT_LAYERS layers, each part in processes of its own (the
    card holds what earlier phases left in this one).  (a) Under NCCL at
    world size 1, bitwise ``train_step``; (b) over TPT_RANKS gloo ranks
    sharing the one card (a (1, 2) mesh: heads 8 + 8 — rank 1 holds 4 real
    heads and 4 padded —, one KV head a rank, ffn and vocab split), held to
    (a).  (b)'s times are gloo's: every collective stages through the host.
    No flash_attention (no backward kernel) on either.  The card's peak of a
    cell call in (a) and on each rank of (b) is held to the dry run's meta
    run of the cell at (1, 1) / (1, TPT_RANKS) (``pool``'s children).
    Returns the launches of (a) and of each rank."""
    import gc

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "dist" / "tp_train"
    work.mkdir(parents=True, exist_ok=True)
    out = {"card": card_name_power(),
           "script_process_bytes": {"allocated": torch.cuda.memory_allocated(),
                                    "reserved": torch.cuda.memory_reserved()}}
    for name in ("nccl_store", "gloo_store"):
        (work / name).unlink(missing_ok=True)
    mp.start_processes(tpt_single, args=(str(work / "nccl_store"), str(work)), nprocs=1,
                       start_method="spawn", join=True)
    one = out["world_size_1"] = json.loads((work / "single.json").read_text())

    t0 = time.perf_counter()
    mp.start_processes(tpt_rank, args=(TPT_RANKS, str(work / "gloo_store"), str(work)),
                       nprocs=TPT_RANKS, start_method="spawn", join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TPT_RANKS)]
    for rep in ranks:
        r = rep["rank"]
        loss_err = max(abs(a / b - 1) for a, b in zip(rep["losses"], one["losses"]))
        norm_err = max(abs(a / b - 1) for a, b in zip(rep["grad_norms"], one["grad_norms"]))
        rep.update(loss_rel_err=loss_err, grad_norm_rel_err=norm_err)
        check(loss_err <= TPT_LOSS_REL_TOL,
              f"tensor_parallel_train (b) rank {r}: losses {rep['losses']} vs {one['losses']}")
        check(norm_err <= TPT_GNORM_REL_TOL,
              f"tensor_parallel_train (b) rank {r}: grad norms {rep['grad_norms']} vs "
              f"{one['grad_norms']}")
        check(rep["m_step1_max_rel_err"] <= TPT_M_REL_TOL,
              f"tensor_parallel_train (b) rank {r}: m after step 1 "
              f"{rep['m_step1_max_rel_err']} off (a)'s at leaf {rep['m_step1_worst_leaf']}")
        check(rep["launches"]["flash_attention"] == 0,
              f"tensor_parallel_train (b) rank {r}: flash_attention launched")
        check(rep["losses"] == ranks[0]["losses"],
              f"tensor_parallel_train (b): ranks' losses differ {rep['losses']}")
    rep0, rep1 = (torch.load(work / f"replicated_rank{r}.pt") for r in range(TPT_RANKS))
    check(all(torch.equal(a, b) for k in rep0 for a, b in zip(rep0[k], rep1[k]))
          and ranks[0]["replicated_leaves"] > 0,
          "tensor_parallel_train (b): replicated leaves differ across ranks")
    out["gloo_ranks"] = {"ranks": ranks, "wall_s": wall, "replicated_leaves_bitwise": True,
                         "note": "gloo stages every collective through the host: these "
                                 "times are not NVLink's; collectives counted over groups "
                                 "of more than one rank"}
    cfg, shape, tcfg = tpt_cell_config()
    meta = meta_peaks(pool, [(cfg, shape, (1, n), ("data", "model"), tcfg)
                             for n in (1, TPT_RANKS)])
    out["peak_holds"] = {
        "world_size_1": peak_hold("tensor_parallel_train (a)", one["cell_peak_bytes"], meta[0]),
        "gloo_ranks": [peak_hold(f"tensor_parallel_train (b) rank {rep['rank']}",
                                 rep["cell_peak_bytes"], meta[1]) for rep in ranks]}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tensor_parallel_train", **out})
    return one["launches"], [rep["launches"] for rep in ranks]


# ----------------------------------------------------------------- phase 14


def tpz_config(arch, kind, cf=None, dtype="bfloat16", parallelism="tp"):
    """Phase 14's config of ``arch`` for ``kind`` ("serve" or "train"), at
    capacity factor ``cf`` where given, computing in ``dtype``, under
    ``parallelism`` (phase 16: "dp")."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch).replace(compute_dtype=dtype, parallelism=parallelism)
    layers = (TPZ_SERVE if kind == "serve" else TPZ_TRAIN)[arch][0]
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    if cf is not None:
        cfg = cfg.replace(capacity_factor=cf)
    return cfg.replace(remat="full") if kind == "train" else cfg


def device_local_params(torch, cfg, dtype, specs, mesh, seed=0, as_dtype=None):
    """``device_params``' weights (the same draws, leaf by leaf) at this
    rank's shards under ``specs``: each leaf is drawn whole on the card,
    sliced and freed, so no rank holds the whole model.  ``as_dtype``: the
    shards cast to it (``dtype``'s values, held wider)."""
    from repro_torch.distributed.sharding import shard_slices
    from repro_torch.interop import tree_flatten, tree_unflatten
    from repro_torch.models.common import is_tuple
    from repro_torch.models.transformer import param_specs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    leaves, treedef = tree_flatten(param_specs(cfg))
    out = []
    with torch.device("cuda"):
        for spec, sp in zip(leaves, tree_flatten(specs, is_tuple)[0]):
            t = spec.make(gen, dtype).to("cuda")
            local = t[shard_slices(sp, t.shape, mesh)]
            out.append(local.clone() if as_dtype in (None, dtype) else local.to(as_dtype))
            del t, local
    return tree_unflatten(treedef, out)


class CollectiveCounter:
    """Counts the calls and bytes of ``torch.distributed``'s all_reduce,
    all_gather and all_to_all_single over groups of more than one rank,
    while active; ``take()`` returns the counts so far and starts anew."""

    OPS = ("all_reduce", "all_gather", "all_to_all_single")

    def __init__(self):
        self.calls = {}

    def take(self) -> dict:
        out, self.calls = self.calls, {}
        return out

    def __enter__(self):
        import torch.distributed as dist

        self.patches = []
        for op in self.OPS:
            def wrap(fn, op=op):
                def inner(*args, group=None, **kw):
                    if dist.get_world_size(group) > 1:
                        t = args[0] if op == "all_reduce" else args[1]
                        c = self.calls.setdefault(op, {"calls": 0, "bytes": 0})
                        c["calls"] += 1
                        c["bytes"] += t.numel() * t.element_size()
                    return fn(*args, group=group, **kw)
                return inner
            self.patches.append(Patched(dist, op, wrap).__enter__())
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.__exit__(*exc)


def tpz_serve(torch, K, FK, mesh, arch, forced=None, cf=None, prefill_only=False,
              reference=False, dtype="bfloat16", steps=TPZ_DECODE_STEPS, parallelism="tp"):
    """``arch``'s prefill cell at TPZ_SERVE's batch and prompt (numpy seed 0
    tokens), then ``steps`` decode-cell steps (:func:`tp_serve`); ``cf``:
    the capacity factor, where given; ``dtype``: the compute's."""
    import numpy as np

    cfg = tpz_config(arch, "serve", cf, dtype, parallelism)
    _, b, prompt = TPZ_SERVE[arch]
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, prompt), dtype=np.int64).astype(np.int32)
    pos0 = cfg.num_meta_tokens + prompt
    return tp_serve(torch, K, FK, mesh, cfg, {"tokens": tokens}, pos0, pos0 + TPZ_DECODE_STEPS,
                    "tensor_parallel_zoo", forced, prefill_only, reference, steps)


def tp_serve(torch, K, FK, mesh, cfg, np_batch, pos0, seq, tag, forced=None,
             prefill_only=False, reference=False, steps=TPZ_DECODE_STEPS):
    """``cfg``'s prefill cell on ``np_batch`` (numpy, whole: each rank takes
    its rows) into a cache of ``seq`` positions, then ``steps`` decode-cell
    steps from position ``pos0``, on ``mesh``, every rank on its own shards
    (bf16 weights from seed 0, drawn rank by rank, held in the compute
    dtype); the decode fed ``forced`` tokens where given, else its own
    greedy ones.  Counts zeroed just before the timed prefill (the second,
    bf16) and read after the decode; ``flash_attention``'s calls counted by
    head offset, the MoE's dropped share by call, the prefills by route.
    With ``reference`` (world size 1) the cells are held bitwise to
    ``T.prefill`` / ``T.decode_step`` on the same weights; ``tag`` names
    the phase in failures.  Returns (report, logits [prefill, each step],
    fed tokens); the report's ``routes``, each route call's expert ids."""
    import torch.distributed as dist

    import repro_torch.models.blocks as blocks
    import repro_torch.models.moe as moe_module
    import repro_torch.models.transformer as T
    from repro_torch import torch_dtype
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import from_numpy
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for

    dtype = cfg.compute_dtype
    b = next(iter(np_batch.values())).shape[0]
    cells = {}
    for kind in ("prefill", "decode"):
        with use_mesh(mesh, rules_for(kind, cfg)):
            cells[kind] = SP.build_cell(cfg, ShapeConfig(kind, seq, b, kind), mesh)
    t0 = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    for r in range(world):              # one rank at a time: the whole leaves are drawn
        if r == rank:
            params = device_local_params(torch, cfg, torch.bfloat16,
                                         cells["prefill"].in_specs[0], mesh,
                                         as_dtype=getattr(torch, dtype))
        torch.cuda.synchronize()
        dist.barrier()
    setup_s = time.perf_counter() - t0
    whole_batch = {k: from_numpy(v, "cuda") for k, v in np_batch.items()}
    batch = SP.local_tree(whole_batch, cells["prefill"].in_specs[1], mesh)
    offsets, drops, routes = {}, [], []

    def by_offset(fn):
        def inner(*args, head_offset=0, **kw):
            offsets[head_offset] = offsets.get(head_offset, 0) + 1
            return fn(*args, head_offset=head_offset, **kw)
        return inner

    def note_drops(fn):
        def inner(*args, **kw):
            y, aux = fn(*args, **kw)
            drops.append(aux["moe_drop_frac"])
            return y, aux
        return inner

    def note_routes(fn):
        def inner(*args, **kw):
            out = fn(*args, **kw)
            routes.append(out[3].sort(-1).values.to(torch.int16).cpu())   # the expert ids
            return out
        return inner

    if dtype == "bfloat16" and not prefill_only:
        cells["prefill"].fn(params, batch)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    T.reset_prefill_routes()
    report = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
              "input_shapes": {k: list(v.shape) for k, v in np_batch.items()},
              "cache_positions": seq, "meta_tokens": cfg.num_meta_tokens,
              "window": cfg.sliding_window,
              "capacity_factor": cfg.capacity_factor if cfg.num_experts else None,
              "weights_setup_s": setup_s}
    with Patched(blocks, "flash_attention", by_offset), \
            Patched(blocks, "moe_forward", note_drops), \
            Patched(moe_module, "route", note_routes), CollectiveCounter() as coll:
        t0 = time.perf_counter()
        logits, cache = cells["prefill"].fn(params, batch)
        torch.cuda.synchronize()
        report["prefill_cell_ms"] = (time.perf_counter() - t0) * 1e3
        report["prefill_collectives"] = coll.take()
        report["prefill_routes"] = dict(T.prefill_routes)
        if cfg.num_experts:
            report["prefill_drop_frac"] = [float(d) for d in drops]
        out_logits, fed = [logits], []
        if not prefill_only:
            cache = SP.local_tree(whole_cache(torch, cache, cells["prefill"].out_specs[1],
                                              mesh), cells["decode"].in_specs[1], mesh)
            nxt, step_ms = logits.argmax(-1).to(torch.int32), []
            for step in range(steps):
                tok = nxt if forced is None else forced[step].to("cuda")
                cur = torch.full_like(tok, pos0 + step)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = cells["decode"].fn(params, cache, tok, cur)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                out_logits.append(logits)
                fed.append(tok)
                nxt = logits.argmax(-1).to(torch.int32)
            report["decode_cell_step_ms"] = step_ms
            report["decode_collectives_per_step"] = {
                op: {k: v / steps for k, v in c.items()}
                for op, c in coll.take().items()}
    report.update(launches=dict(K.launch_counts), flash_attention_variants=dict(FK.variant_counts),
                  flash_attention_calls_by_head_offset=offsets,
                  peak_memory_bytes=torch.cuda.max_memory_allocated())
    kv_spec = cells["decode"].in_specs[1][0].get("k")
    if kv_spec is not None and not prefill_only:
        report["decode_kv_spec"] = list(kv_spec)
    del cache
    if reference:
        cache = T.init_cache(cfg, b, seq, torch_dtype(cfg.compute_dtype), device="cuda")
        hidden, cache = T.prefill(cfg, params, whole_batch, cache)
        check(torch.equal(T.lm_logits(cfg, params, hidden), out_logits[0]),
              f"{tag} (a) {cfg.name}: prefill-cell logits not bitwise T.prefill's")
        for step, tok in enumerate(fed):
            check(forced is not None or step == 0 or
                  torch.equal(tok, out_logits[step].argmax(-1).to(torch.int32)),
                  f"{tag} (a) {cfg.name}: greedy token {step}")
            lg, cache = T.decode_step(cfg, params, cache, tok, torch.full_like(tok, pos0 + step))
            check(torch.equal(lg, out_logits[step + 1]),
                  f"{tag} (a) {cfg.name}: decode-cell logits {step} not bitwise "
                  "T.decode_step's")
        report["bitwise_prefill_decode_step"] = True
        del cache, hidden
    del params
    torch.cuda.empty_cache()
    report["routes"] = routes
    return report, out_logits, (torch.stack(fed) if fed else None)


def tpz_batches(cfg, b, seq):
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for _ in range(TPZ_TRAIN_STEPS):
        t = rng.integers(0, cfg.vocab_size, (b, seq + 1), dtype=np.int64).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def tpz_train_cell(torch, mesh, arch, dtype="bfloat16", parallelism="tp", donate=False,
                   steps=TPZ_TRAIN_STEPS):
    """Phase 14's train config of ``arch``, its cell on ``mesh`` (phase 16:
    under ``parallelism`` "dp", donating its arguments) and its first
    ``steps`` batches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = tpz_config(arch, "train", TPZ_NODROP_CF.get(arch), dtype, parallelism)
    _, b, seq = TPZ_TRAIN[arch]
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=TPZ_LR, warmup_steps=1))
    if arch in TPZ_NODROP_CF:       # EP: the load-balance loss is per token slice
        tcfg = dataclasses.replace(tcfg, moe_lb_coeff=0.0)
    with use_mesh(mesh, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("train_tp", seq, b, "train"), mesh, tcfg,
                             donate=donate)
    return cfg, tcfg, cell, tpz_batches(cfg, b, seq)[:steps]


def fingerprint(torch, tree) -> list:
    """Per leaf, two sums over its bits read as int32 (plain and squared,
    int64), -0.0 read as 0.0: leaves ``torch.equal`` holds equal print
    equal, and leaves that differ print equal by a chance of the order of
    2^-64."""
    from repro_torch.interop import tree_flatten

    out = []
    for t in tree_flatten(tree)[0]:
        bits = (t.detach() + 0).contiguous().view(-1).view(torch.int32)
        a = b = 0
        for c in bits.split(1 << 26):
            c = c.long()
            a += int(c.sum())
            b += int((c * c).sum())
        out.append((a, b))
    return out


def m1_sample(t):
    """A moment leaf as phase 14 keeps it on the host to compare: every
    element of a leaf up to 2^20 elements, every 16th (flattened) of a
    larger one, whose relative error it estimates; the disk takes a
    sixteenth of the full-width experts' moments."""
    flat = t.detach().reshape(-1)
    return (flat[::16] if flat.numel() > 1 << 20 else flat).cpu().clone()


def tpz_first_m(torch, cell, mesh, batch, params, state) -> list:
    """The cell's m after its first step from ``params`` and ``state``."""
    from repro_torch.interop import tree_flatten

    _, state, _ = cell.fn(params, state, tpt_batch(torch, cell, mesh, batch))
    return tree_flatten(state.m)[0]


def tp_rank_m_specs(cfg) -> tuple:
    """(b)'s (1, TPZ_RANKS) mesh as a ``MeshSpec`` and the ZeRO-1 moment
    specs (tree order) of ``cfg``'s tensor-parallel train cell on it: the
    slices of (a)'s m after step 1 that (b)'s ranks hold."""
    from repro_torch.distributed.sharding import MeshSpec, use_mesh
    from repro_torch.interop import tree_flatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.common import is_tuple

    cfg = cfg.replace(parallelism="tp")
    ranks_mesh = MeshSpec(("data", "model"), (1, TPZ_RANKS))
    with use_mesh(ranks_mesh, rules_for("train", cfg)):
        return ranks_mesh, tree_flatten(SP.opt_pspecs(cfg, ranks_mesh).m, is_tuple)[0]


def tpz_train_single(torch, K, mesh, arch, work, train_cell=tpz_train_cell,
                     tag="tensor_parallel_zoo"):
    """(a)'s train part: the TP train cell at world size 1 for
    TPZ_TRAIN_STEPS steps, then ``train_step`` from the same weights, one
    training state on the card at a time, both under deterministic
    algorithms; params, m and v equal after every step (through their
    bits' ``fingerprint``), losses and grad norms equal.  Then the cell's
    first step computing in fp32, and each leaf's bf16 m after step 1 off
    the fp32 one (the model's own bf16 error).  Saves the cell's m after
    step 1 in bf16 and fp32 compute as each of (b)'s ranks holds it."""
    from repro_torch.distributed.sharding import shard_slices
    from repro_torch.interop import tree_flatten
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.train_step import train_step

    cfg, tcfg, cell, batches = train_cell(torch, mesh, arch)
    ranks_mesh, m_specs = tp_rank_m_specs(cfg)

    def save_m1(m1, tag):
        for r in range(TPZ_RANKS):
            torch.save([m1_sample(t[shard_slices(s, t.shape, ranks_mesh, (0, r))])
                        for t, s in zip(m1, m_specs)], work / f"m1{tag}_{arch}_rank{r}.pt")

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    # train_step alone is not reproducible on the card by default: the
    # backward of GQA's KV expansion (index_select) adds with atomics
    torch.use_deterministic_algorithms(True, warn_only=True)
    for name in ("cell", "train_step"):
        params = device_params(torch, cfg, torch.float32)
        n_params = sum(t.numel() for t in tree_flatten(params)[0])
        state = init_state(params)
        run = runs[name] = {"losses": [], "grad_norms": [], "step_ms": [], "prints": []}
        for i, batch in enumerate(batches):
            feed = tpt_batch(torch, cell, mesh, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "cell":
                params, state, m = cell.fn(params, state, feed)
            else:
                params, state, m = train_step(cfg, tcfg, params, state, feed)
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["losses"].append(m["loss"].item())
            run["grad_norms"].append(m["grad_norm"].item())
            run["prints"].append(fingerprint(torch, (params, state.m, state.v)))
            if name == "cell" and i == 0:
                m1 = tree_flatten(state.m)[0]
                save_m1(m1, "")
                m1 = [m1_sample(t) for t in m1]
        del params, state, m, feed
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    cell_run, ref = runs["cell"], runs["train_step"]
    differ = [i + 1 for i in range(TPZ_TRAIN_STEPS) if cell_run["prints"][i] != ref["prints"][i]]
    check(not differ, f"{tag} (a) {arch}: params / m / v after steps {differ} "
                      "not train_step's")
    check(cell_run["losses"] == ref["losses"] and cell_run["grad_norms"] == ref["grad_norms"],
          f"{tag} (a) {arch}: losses {cell_run['losses']} / {ref['losses']}")
    launches = dict(K.launch_counts)
    check(launches["flash_attention"] == 0,
          f"{tag} (a) {arch} train: flash_attention launched {launches}")
    peak = torch.cuda.max_memory_allocated()

    # the same first step computing in fp32: the bf16 m's own error, per leaf
    cfg32, _, cell32, _ = train_cell(torch, mesh, arch, "float32")
    params = device_params(torch, cfg32, torch.float32)
    m32 = tpz_first_m(torch, cell32, mesh, batches[0], params, init_state(params))
    del params
    save_m1(m32, "32")
    m32 = [m1_sample(t) for t in m32]
    bf16_err = [((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(m1, m32)]
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
            "batch": {k: list(v.shape) for k, v in batches[0].items()},
            "capacity_factor": cfg.capacity_factor if cfg.num_experts else None,
            "losses": cell_run["losses"], "grad_norms": cell_run["grad_norms"],
            "step_ms": {"cell": cell_run["step_ms"], "train_step": ref["step_ms"]},
            "bitwise_equal_train_step": True, "deterministic_algorithms": True,
            "m_step1_bf16_vs_fp32_rel_err": bf16_err,
            "launches": launches, "peak_memory_bytes": peak,
            "note": "one training state on the card at a time; equal through fingerprints "
                    "of every leaf's bits"}


def tpz_train_rank(torch, K, mesh, arch, work, rank, train_cell=tpz_train_cell,
                   tag="tensor_parallel_zoo", ref_work=None):
    """(b)'s train part on one rank: the TP train cell from (a)'s weights
    (drawn rank by rank) and batches, its m after step 1 against (a)'s slice
    (per leaf, on the host); its replicated leaves' bit ``fingerprint`` in
    the report, for the ranks' comparison; then the first step computing in
    fp32, against (a)'s.  (a)'s files are read from ``ref_work`` (default
    ``work``); a cell that splits no leaf (phase 16's dp) holds its whole m
    against every (b) rank's slice of (a)'s."""
    import math

    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_slices
    from repro_torch.interop import tree_flatten, tree_map
    from repro_torch.models.common import is_tuple, shapes_tree
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.optimizer import AdamWState

    def local_state(cfg, cell):
        """This rank's weights (drawn rank by rank) and zero moments."""
        for r in range(dist.get_world_size()):
            if r == rank:
                params = device_local_params(torch, cfg, torch.float32, cell.in_specs[0], mesh)
            torch.cuda.synchronize()
            dist.barrier()
        shapes = shapes_tree(param_specs(cfg))

        def zeros():
            return tree_map(lambda shp, s: torch.zeros(
                torch.empty(shp, device="meta")[shard_slices(s, shp, mesh)].shape,
                dtype=torch.float32, device="cuda"), shapes, cell.in_specs[1].m,
                is_leaf=is_tuple)

        return params, AdamWState(torch.zeros((), dtype=torch.int32, device="cuda"), zeros(),
                                  zeros())

    ref = work if ref_work is None else ref_work

    def m1_errs(m1, name):
        if any(split):
            pairs = [(m1, torch.load(ref / f"m1{name}_{arch}_rank{rank}.pt"))]
        else:
            ranks_mesh, m_specs = tp_rank_m_specs(cfg)
            pairs = [([t[shard_slices(sp, t.shape, ranks_mesh, (0, r))]
                       for t, sp in zip(m1, m_specs)],
                      torch.load(ref / f"m1{name}_{arch}_rank{r}.pt")) for r in range(TPZ_RANKS)]
        out = []
        for j in range(len(m1)):
            diff = norm = 0.0
            for got_leaves, want in pairs:
                got = m1_sample(got_leaves[j])
                check(got.shape == want[j].shape, f"{tag} (b) {arch}: m{j} shape")
                diff += (got - want[j]).double().norm().item() ** 2
                norm += want[j].double().norm().item() ** 2
            out.append(math.sqrt(diff) / max(math.sqrt(norm), 1e-30))
        return out

    cfg, tcfg, cell, batches = train_cell(torch, mesh, arch)
    split = [any(e is not None for e in s) for s in tree_flatten(cell.in_specs[0], is_tuple)[0]]
    params, state = local_state(cfg, cell)
    losses, norms, step_ms, m1_err = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with CollectiveCounter() as coll:
        for i, batch in enumerate(batches):
            feed = tpt_batch(torch, cell, mesh, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = cell.fn(params, state, feed)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            if i == 0:
                m1_err = m1_errs(tree_flatten(state.m)[0], "")
        calls = coll.take()
    prints = fingerprint(torch, [[t for t, sp in zip(tree_flatten(tree)[0], split) if not sp]
                                 for tree in (params, state.m, state.v)])
    report = {"arch": cfg.name, "layers": cfg.num_layers, "losses": losses,
              "grad_norms": norms, "step_ms": step_ms,
              "collectives_per_step": {op: {k: v / len(batches) for k, v in c.items()}
                                       for op, c in calls.items()},
              "replicated_prints": prints,
              "m_step1_rel_err": m1_err, "launches": dict(K.launch_counts),
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "replicated_leaves": len(split) - sum(split), "split_leaves": sum(split)}
    del params, state
    torch.cuda.empty_cache()
    # the first step computing in fp32, held to (a)'s
    cfg32, _, cell32, _ = train_cell(torch, mesh, arch, "float32")
    params, state = local_state(cfg32, cell32)
    report["m_step1_fp32_rel_err"] = m1_errs(tpz_first_m(torch, cell32, mesh, batches[0],
                                                         params, state), "32")
    del params, state
    torch.cuda.empty_cache()
    return report


def tpz_single_part(torch, K, FK, mesh, work) -> dict:
    """Phase 14's (a) part, in :func:`tp_models_single`'s process: every
    model's prefill and decode cells (and phi3.5-moe's prefill cell at its
    published capacity factor), then every train cell, on the (1, 1) mesh;
    writes its logits and greedy tokens, returns its report."""
    import numpy as np

    report = {"serve": {}, "train": {}}
    for arch in TPZ_SERVE:
        rep, logits, fed = tpz_serve(torch, K, FK, mesh, arch, cf=TPZ_NODROP_CF.get(arch),
                                     reference=True)
        torch.save(rep.pop("routes"), work / f"routes_{arch}.pt")
        report["serve"][arch] = rep
        np.save(work / f"logits_{arch}.npy",
                torch.stack([lg.float() for lg in logits]).cpu().numpy())
        np.save(work / f"tokens_{arch}.npy", fed.cpu().numpy())
        rep, logits, _ = tpz_serve(torch, K, FK, mesh, arch, forced=fed,
                                   cf=TPZ_NODROP_CF.get(arch), dtype="float32",
                                   steps=TPZ_FP32_STEPS)
        torch.save(rep.pop("routes"), work / f"routes32_{arch}.pt")
        report["serve"][arch]["float32"] = rep
        np.save(work / f"logits32_{arch}.npy", torch.stack(logits).cpu().numpy())
        if arch in TPZ_NODROP_CF:
            rep, logits, _ = tpz_serve(torch, K, FK, mesh, arch, prefill_only=True)
            del rep["routes"]
            report["serve"][arch]["published_capacity"] = rep
            np.save(work / f"logits_{arch}_published.npy", logits[0].float().cpu().numpy())
    for arch in TPZ_TRAIN:
        report["train"][arch] = tpz_train_single(torch, K, mesh, arch, work)
    return report


def tpz_rank_part(torch, K, FK, mesh, work, rank) -> dict:
    """Phase 14's (b) part on one rank, in :func:`tp_models_rank`'s
    process: (a)'s cells on the (1, TPZ_RANKS) mesh, the decode
    teacher-forced with (a)'s tokens; rank 0 writes the logits; returns the
    rank's report."""
    import numpy as np

    report = {"rank": rank, "coordinate": list(mesh.get_coordinate()), "serve": {},
              "train": {}}
    for arch in TPZ_SERVE:
        forced = torch.from_numpy(np.load(work / f"tokens_{arch}.npy"))
        rep, logits, _ = tpz_serve(torch, K, FK, mesh, arch, forced=forced,
                                   cf=TPZ_NODROP_CF.get(arch))
        torch.save(rep.pop("routes"), work / f"routes_{arch}_rank{rank}.pt")
        report["serve"][arch] = rep
        if rank == 0:
            np.save(work / f"ranks_logits_{arch}.npy",
                    torch.stack([lg.float() for lg in logits]).cpu().numpy())
        rep, logits, _ = tpz_serve(torch, K, FK, mesh, arch, forced=forced,
                                   cf=TPZ_NODROP_CF.get(arch), dtype="float32",
                                   steps=TPZ_FP32_STEPS)
        torch.save(rep.pop("routes"), work / f"routes32_{arch}_rank{rank}.pt")
        report["serve"][arch]["float32"] = rep
        if rank == 0:
            np.save(work / f"ranks_logits32_{arch}.npy", torch.stack(logits).cpu().numpy())
        if arch in TPZ_NODROP_CF:
            rep, logits, _ = tpz_serve(torch, K, FK, mesh, arch, prefill_only=True)
            del rep["routes"]
            report["serve"][arch]["published_capacity"] = rep
            if rank == 0:
                np.save(work / f"ranks_logits_{arch}_published.npy",
                        logits[0].float().cpu().numpy())
        del logits
    for arch in TPZ_TRAIN:
        report["train"][arch] = tpz_train_rank(torch, K, mesh, arch, work, rank)
    return report


def route_flips(torch, cfg, batch, want, ranks, steps=TPZ_DECODE_STEPS) -> "torch.Tensor":
    """[1 + steps, batch] bools: whether the experts of ``ranks``
    (each rank's route calls; EP ranks route their slices of the tokens,
    gathered here in rank order) for the token each logits row is read at
    (the prefill's last position, then each step's token) differ from
    ``want``'s in any layer."""
    layers = cfg.num_layers if cfg.num_experts else 0
    out = torch.zeros((1 + steps, batch), dtype=torch.bool)
    if not layers:
        return out
    check(len(want) == len(ranks[0]) == (1 + steps) * layers,
          f"tensor_parallel_zoo {cfg.name}: {len(want)} / {len(ranks[0])} route calls")
    for c, ids in enumerate(want):
        mine = ranks[0][c] if ranks[0][c].shape == ids.shape else torch.cat([r[c] for r in ranks])
        per_row = ids.shape[0] // batch                    # tokens a row: the last is read
        rows = torch.arange(batch) * per_row + per_row - 1
        out[c // layers] |= (mine[rows] != ids[rows]).any(-1)
    return out


def row_errs(torch, got, want):
    """||got - want|| / ||want|| of every row (the padded vocabulary, NEG_INF
    in both, left out)."""
    live = want.reshape(-1, want.shape[-1])[0] > -1e8
    g, w = got[..., live].double(), want[..., live].double()
    return (g - w).norm(dim=-1) / w.norm(dim=-1)


def hold_train_ranks(torch, one, ranks, archs, tag, hold, held):
    """(b)'s train cells against (a)'s, for phases 14 to 16: each rank's
    losses within TPT_LOSS_REL_TOL and grad norms within TPT_GNORM_REL_TOL of
    (a)'s; its m after step 1 within TPT_M_REL_TOL of (a)'s slice or twice
    (a)'s own bf16 error, whichever is larger, and in fp32 within
    TPZ_FP32_M_TOL (per leaf); no kernel launched; the ranks' losses equal
    and their replicated leaves bitwise (their bits' ``fingerprint``).
    Failures go to ``hold``."""
    for arch in archs:
        a = one["train"][arch]
        for r, rep in enumerate(ranks):
            t = rep["train"][arch]
            loss_err = max(abs(x / y - 1) for x, y in zip(t["losses"], a["losses"]))
            norm_err = max(abs(x / y - 1) for x, y in zip(t["grad_norms"], a["grad_norms"]))
            t.update(loss_rel_err=loss_err, grad_norm_rel_err=norm_err)
            hold(loss_err <= TPT_LOSS_REL_TOL,
                 f"{tag} (b) {arch} rank {r}: losses {t['losses']} vs "
                 f"{a['losses']}")
            hold(norm_err <= TPT_GNORM_REL_TOL,
                 f"{tag} (b) {arch} rank {r}: grad norms {t['grad_norms']} vs "
                 f"{a['grad_norms']}")
            own = a["m_step1_bf16_vs_fp32_rel_err"]
            over = {j: (e, own[j]) for j, e in enumerate(t["m_step1_rel_err"])
                    if e > max(TPT_M_REL_TOL, 2 * own[j])}
            t["m_step1_max_rel_err"] = max(t["m_step1_rel_err"])
            t["m_step1_fp32_max_rel_err"] = max(t["m_step1_fp32_rel_err"])
            hold(not over, f"{tag} (b) {arch} rank {r}: m after step 1 off "
                          f"(a)'s at leaves (error, (a)'s own bf16 error) {over}")
            hold(t["m_step1_fp32_max_rel_err"] <= TPZ_FP32_M_TOL,
                 f"{tag} (b) {arch} rank {r} fp32: m after step 1 "
                 f"{t['m_step1_fp32_rel_err']}")
            hold(t["launches"]["flash_attention"] == 0,
                 f"{tag} (b) {arch} rank {r}: flash_attention launched")
            hold(t["losses"] == ranks[0]["train"][arch]["losses"],
                 f"{tag} (b) {arch}: ranks' losses differ")
        prints = [rep["train"][arch]["replicated_prints"] for rep in ranks]
        hold(all(p == prints[0] for p in prints)
             and ranks[0]["train"][arch]["replicated_leaves"] > 0,
             f"{tag} (b) {arch}: replicated leaves differ across ranks")
        held.setdefault(arch, {})["train_replicated_leaves_bitwise"] = True


def hold_serve_ranks(torch, arch, cfg, one, ranks, a_work, b_work, tag, hold, per) -> dict:
    """(b)'s prefill and decode cells of ``arch`` (``cfg``) against (a)'s, for phases 14
    and 16: (a)'s logits, tokens and routes under ``a_work``, (b)'s (rank
    0's logits, every rank's routes) under ``b_work``.  Rows whose token
    some layer routes otherwise than (a) are reported, not held, and must be
    fewer than half; the rest within TP_LOGITS_ROW_TOL or twice (a)'s own
    bf16 error, fp32 within TPZ_FP32_ROW_TOL, each fed token within TOL of
    (a)'s top logit; every prefill's flash_attention hopper at head offset
    ``r * per`` on rank ``r``.  Failures go to ``hold``; returns the held
    numbers."""
    import numpy as np

    a_load = lambda name: torch.from_numpy(np.load(a_work / f"{name}_{arch}.npy"))  # noqa: E731
    b_load = lambda name: torch.from_numpy(np.load(b_work / f"{name}_{arch}.npy"))  # noqa: E731
    routes = {t: (torch.load(a_work / f"routes{t}_{arch}.pt"),
                  [torch.load(b_work / f"routes{t}_{arch}_rank{r}.pt")
                   for r in range(TPZ_RANKS)]) for t in ("", "32")}
    want, got = a_load("logits"), b_load("ranks_logits")
    want32, got32 = a_load("logits32"), b_load("ranks_logits32")
    b = want.shape[1]
    flipped = route_flips(torch, cfg, b, *routes[""])
    n32 = 1 + TPZ_FP32_STEPS
    flipped32 = route_flips(torch, cfg, b, *routes["32"], steps=TPZ_FP32_STEPS)
    bf16_flipped = route_flips(torch, cfg, b, routes["32"][0],
                               [routes[""][0][:len(routes["32"][0])]], steps=TPZ_FP32_STEPS)
    errs, errs32 = row_errs(torch, got, want), row_errs(torch, got32, want32)
    # the model's own bf16 error (against fp32 on the same weights and
    # tokens, its first TPZ_FP32_STEPS steps), where (a) routes alike in
    # both and (b) as (a)
    own = row_errs(torch, want[:n32], want32).masked_fill(
        flipped[:n32] | bf16_flipped, 0).max().item()
    limit = max(TP_LOGITS_ROW_TOL, 2 * own)
    tol = TOL["bfloat16"]
    mine, top = got.argmax(-1), want.max(-1).values
    gap = top - want.gather(-1, mine[..., None])[..., 0]
    held_rows = ~flipped
    hold(int(held_rows.sum()) * 2 > held_rows.numel(),
         f"{tag} (b) {arch}: routing differs from (a)'s on "
         f"{int(flipped.sum())} of {flipped.numel()} rows")
    hold(float(errs.masked_fill(flipped, 0).max()) <= limit,
         f"{tag} (b) {arch}: logits row errors {errs.tolist()} over "
         f"{limit}, routing differing on {flipped.tolist()}")
    hold(float(errs32.masked_fill(flipped32, 0).max()) <= TPZ_FP32_ROW_TOL
         and int((~flipped32).sum()) * 2 > flipped32.numel(),
         f"{tag} (b) {arch} fp32: logits row errors {errs32.tolist()}, "
         f"routing differing on {flipped32.tolist()}")
    hold(bool((gap[held_rows] <= tol["atol"] + tol["rtol"] * top[held_rows].abs()).all()),
         f"{tag} (b) {arch}: a fed token is {gap.max().item()} below (a)'s top logit")
    equal = int((mine == want.argmax(-1)).sum())
    for r, rep in enumerate(ranks):
        s = rep["serve"][arch]
        n = s["launches"]["flash_attention"]
        hold(n == cfg.num_layers
             and s["flash_attention_variants"] == {"hopper": n, "generic": 0}
             and s["flash_attention_calls_by_head_offset"] == {str(r * per): n},
             f"{tag} (b) {arch} rank {r}: {s['flash_attention_variants']}, "
             f"{s['flash_attention_calls_by_head_offset']}")
    a = one["serve"][arch]
    n = a["launches"]["flash_attention"]
    hold(n == cfg.num_layers and a["flash_attention_variants"] == {"hopper": n, "generic": 0}
         and a["flash_attention_calls_by_head_offset"] == {"0": n},
         f"{tag} (a) {arch}: {a['flash_attention_variants']}, "
         f"{a['flash_attention_calls_by_head_offset']}")
    return {"logits_row_err": errs.masked_fill(flipped, 0).max(-1).values.tolist(),
            "limit": limit, "bf16_own_row_err": own,
            "greedy_tokens_equal": equal, "greedy_tokens": mine.numel(),
            "rows_routed_otherwise": int(flipped.sum()), "rows": flipped.numel(),
            "their_logits_row_err": errs[flipped].tolist(),
            "float32": {"logits_row_err": float(errs32.masked_fill(flipped32, 0).max()),
                        "rows_routed_otherwise": int(flipped32.sum()),
                        "their_logits_row_err": errs32[flipped32].tolist()}}


def phase_tensor_parallel_zoo(torch, work, out, spawned):
    """Phase 14's holds and line: the MoE and hymba cells tensor-parallel
    over ``model`` at full width (TPZ_SERVE, TPZ_TRAIN), each part run in
    processes of its own (:func:`phase_tensor_parallel_models`), its
    results under ``work``; ``out`` holds ``flash_attention`` on rank 1's
    heads at (b)'s prefill shapes (TPZ_FLASH_CASES), as phase 12 (a).
    ``seconds``: those cases, the parts' own wall times and the holds
    (``spawned``: the shared processes').  (a) Under NCCL at world size 1: the
    prefill and decode cells bitwise ``T.prefill`` / ``T.decode_step``, the
    train cell bitwise ``train_step`` (both under deterministic algorithms);
    then the same weights and tokens computing in fp32.  (b) Over
    TPZ_RANKS gloo ranks sharing the card (a (1, 2) mesh: mixtral's expert
    d_ff, phi3.5-moe's experts, hymba's Mamba channels, and the heads, ffn
    and vocab, split; the decode caches by sequence), fed (a)'s tokens, held
    to (a):

    * fp32 (the tensor-parallel arithmetic alone): logits within
      TPZ_FP32_ROW_TOL (row norm), m after step 1 within TPZ_FP32_M_TOL of
      (a)'s slice, per leaf;
    * bf16: logits within TP_LOGITS_ROW_TOL or twice (a)'s own bf16 error
      (against its fp32 run), whichever is larger; each fed token within
      TOL of (a)'s top logit; train losses within TPT_LOSS_REL_TOL, grad
      norms within TPT_GNORM_REL_TOL; m after step 1 within TPT_M_REL_TOL
      of (a)'s slice or twice (a)'s own bf16 error, per leaf; replicated
      leaves bitwise across the ranks.

    Logits rows whose token some layer routes to other experts than (a)
    does (a discrete change of the function, from rounding) are reported,
    not held; they must be fewer than half.  Every prefill's
    flash_attention hopper at the rank's head offset.  (b)'s times are
    gloo's: every collective stages through the host.  Returns the launches
    of (a) and of each rank, by model, and the flash_attention cases."""
    import numpy as np

    t_phase = time.perf_counter()
    one = out["world_size_1"] = json.loads((work / "single.json").read_text())
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TPZ_RANKS)]
    wall = max(rep["wall_s"] for rep in ranks)
    held, failures = {}, []

    def hold(cond, msg):
        if not cond:
            failures.append(msg)

    for arch in TPZ_SERVE:
        cfg = tpz_config(arch, "serve")
        a = one["serve"][arch]
        held[arch] = hold_serve_ranks(torch, arch, cfg, one, ranks, work, work,
                                      "tensor_parallel_zoo", hold, cfg.padded_heads // TPZ_RANKS)
        if arch in TPZ_NODROP_CF:
            w = torch.from_numpy(np.load(work / f"logits_{arch}_published.npy"))
            g = torch.from_numpy(np.load(work / f"ranks_logits_{arch}_published.npy"))
            held[arch]["published_capacity"] = {
                "capacity_factor": tpz_config(arch, "serve").capacity_factor,
                "logits_row_err": logits_row_err(torch, g, w),
                "drop_frac_world_size_1": a["published_capacity"].get("prefill_drop_frac"),
                "drop_frac_by_rank": [rep["serve"][arch]["published_capacity"]
                                      .get("prefill_drop_frac") for rep in ranks],
                "note": "capacity is per dispatch shard: not held"}
    hold_train_ranks(torch, one, ranks, TPZ_TRAIN, "tensor_parallel_zoo", hold, held)
    out["gloo_ranks"] = {"ranks": ranks, "wall_s": wall, "held": held,
                         "note": "gloo stages every collective through the host: these "
                                 "times are not NVLink's; collectives counted over groups "
                                 "of more than one rank"}
    out["seconds"] = (out["flash_cases_s"] + one["wall_s"] + wall
                      + time.perf_counter() - t_phase)
    out["shared_processes"] = spawned
    out["failures"] = failures
    emit({"phase": "tensor_parallel_zoo", **out})
    check(not failures, "tensor_parallel_zoo: " + "; ".join(failures))
    return ({arch: s["launches"] for arch, s in one["serve"].items()},
            [{arch: s["launches"] for arch, s in rep["serve"].items()} for rep in ranks],
            out["head_offset"])


# ----------------------------------------------------------------- phase 15


def tpr_config(arch, kind, dtype="bfloat16"):
    """Phase 15's config of ``arch`` for ``kind`` ("serve" or "train"),
    computing in ``dtype``."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch).replace(compute_dtype=dtype)
    layers = (TPR_SERVE if kind == "serve" else TPR_TRAIN)[arch][0]
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    return cfg.replace(remat="full") if kind == "train" else cfg


def mrope_positions(n, grid=None):
    """[1, 3, n] int32 M-RoPE positions: all three rows the index, or with
    ``grid``, text tokens, a ``grid`` x ``grid`` image block (its temporal
    position constant, height and width the grid) and text tokens past the
    block's largest position (Qwen2-VL's position rule; ``vlm_positions``'
    layout at any length)."""
    import numpy as np

    if grid is None:
        return np.broadcast_to(np.arange(n, dtype=np.int32), (1, 3, n)).copy()
    t0 = (n - grid * grid) // 2
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    block = np.stack([np.full(grid * grid, t0), t0 + hh.ravel(), t0 + ww.ravel()])
    start = t0 + grid
    pos = np.concatenate([np.tile(np.arange(t0), (3, 1)), block,
                          np.tile(np.arange(start, start + n - t0 - grid * grid), (3, 1))],
                         axis=1)
    return pos[None].astype(np.int32)


def tpr_inputs(cfg, b, n, grid=None, frames=None, seed=0):
    """Numpy inputs of ``b`` x ``n`` from ``seed``: tokens, or embeddings and
    positions (:func:`mrope_positions`) for an embeddings model; an
    encoder-decoder's ``frames`` frame embeddings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        out = {"embeds": rng.standard_normal((b, n, cfg.d_model), dtype=np.float32),
               "positions": np.repeat(mrope_positions(n, grid), b, axis=0)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, n), dtype=np.int64)
               .astype(np.int32)}
    if cfg.is_encdec:
        out["src_embeds"] = rng.standard_normal((b, frames, cfg.d_model), dtype=np.float32)
    return out


def tpr_serve(torch, K, FK, mesh, arch, forced=None, reference=False, dtype="bfloat16",
              steps=TPZ_DECODE_STEPS, image=False):
    """``arch``'s prefill cell at TPR_SERVE's batch and prompt, then
    ``steps`` decode-cell steps (:func:`tp_serve`); ``image``: qwen2-vl's
    image-block prompt, prefill only."""
    cfg = tpr_config(arch, "serve", dtype)
    _, b, n = TPR_SERVE[arch]
    batch = tpr_inputs(cfg, b, n, VLM_GRID if image else None,
                       TPR_FRAMES if cfg.is_encdec else None)
    pos0 = int(batch["positions"].max()) + 1 if "positions" in batch else n
    seq = n + TPZ_DECODE_STEPS + (arch == TPR_HEAD_CACHE)     # odd for the KV-head cache
    return tp_serve(torch, K, FK, mesh, cfg, batch, pos0, seq, "tensor_parallel_rest",
                    forced, image, reference, steps)


def tpr_train_cell(torch, mesh, arch, dtype="bfloat16"):
    """Phase 15's train config of ``arch``, its cell on ``mesh`` and its
    TPZ_TRAIN_STEPS batches (numpy seed 0 labels and tokens; embeddings,
    image-block positions and frames from seeds 1, 2, ...)."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = tpr_config(arch, "train", dtype)
    _, b, seq = TPR_TRAIN[arch]
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=TPZ_LR, warmup_steps=1))
    with use_mesh(mesh, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("train_tp", seq, b, "train"), mesh, tcfg)
    rng = np.random.default_rng(0)
    batches = []
    for i in range(TPZ_TRAIN_STEPS):
        t = rng.integers(0, cfg.vocab_size, (b, seq + 1), dtype=np.int64).astype(np.int32)
        batch = tpr_inputs(cfg, b, seq, VLM_GRID, seq if cfg.is_encdec else None, seed=i + 1)
        if "tokens" in batch:
            batch["tokens"] = t[:, :-1]
        batch["labels"] = t[:, 1:]
        batches.append(batch)
    return cfg, tcfg, cell, batches


def tpr_serve_runs(torch, K, FK, mesh, arch, work, rank=None):
    """(a)'s (``rank`` None, world size 1: bitwise the single-device
    functions) or (b)'s (``rank``: fed (a)'s tokens) serve runs of
    ``arch``: bf16, then fp32 on the same weights and tokens
    (TPZ_FP32_STEPS steps), then qwen2-vl's image-block prompt in both.
    The bf16 runs of (a) held bitwise to ``T.prefill`` / ``T.decode_step``.
    Writes the logits (and (a)'s fed tokens) under ``work``; returns the
    reports."""
    import numpy as np

    tail = "" if rank is None else "_ranks"
    forced = (None if rank is None
              else torch.from_numpy(np.load(work / f"tokens_{arch}.npy")))

    def save(name, logits):
        if rank in (None, 0):
            np.save(work / f"{name}{tail}_{arch}.npy",
                    torch.stack([lg.float() for lg in logits]).cpu().numpy())

    rep, logits, fed = tpr_serve(torch, K, FK, mesh, arch, forced=forced,
                                 reference=rank is None)
    del rep["routes"]
    report = rep
    save("logits", logits)
    if rank is None:
        np.save(work / f"tokens_{arch}.npy", fed.cpu().numpy())
        forced = fed
    rep, logits, _ = tpr_serve(torch, K, FK, mesh, arch, forced=forced, dtype="float32",
                               steps=TPZ_FP32_STEPS)
    del rep["routes"]
    report["float32"] = rep
    save("logits32", logits)
    if arch == TPR_VLM:
        for dtype, name in (("bfloat16", "image"), ("float32", "image32")):
            rep, logits, _ = tpr_serve(torch, K, FK, mesh, arch, dtype=dtype, image=True,
                                       reference=rank is None and dtype == "bfloat16")
            del rep["routes"]
            report[name] = rep
            save(name, logits)
    return report


def tpr_single_part(torch, K, FK, mesh, work) -> dict:
    """Phase 15's (a) part, in :func:`tp_models_single`'s process: every
    model's prefill and decode cells, then every train cell, on the (1, 1)
    mesh; writes its logits and greedy tokens, returns its report."""
    return {"serve": {arch: tpr_serve_runs(torch, K, FK, mesh, arch, work)
                      for arch in TPR_SERVE},
            "train": {arch: tpz_train_single(torch, K, mesh, arch, work, tpr_train_cell,
                                             "tensor_parallel_rest")
                      for arch in TPR_TRAIN}}


def tpr_rank_part(torch, K, FK, mesh, work, rank) -> dict:
    """Phase 15's (b) part on one rank, as :func:`tpz_rank_part`."""
    return {"rank": rank, "coordinate": list(mesh.get_coordinate()),
            "serve": {arch: tpr_serve_runs(torch, K, FK, mesh, arch, work, rank)
                      for arch in TPR_SERVE},
            "train": {arch: tpz_train_rank(torch, K, mesh, arch, work, rank, tpr_train_cell,
                                           "tensor_parallel_rest")
                      for arch in TPR_TRAIN}}


def dpm_train_cell(torch, mesh, arch, dtype="bfloat16"):
    """Phase 16's train cell of ``arch``: phase 14's under "dp", donating
    its arguments, DPM_TRAIN_STEPS batches."""
    return tpz_train_cell(torch, mesh, arch, dtype, "dp", donate=True, steps=DPM_TRAIN_STEPS)


def dpm_rank_part(torch, K, FK, mesh, work, rank) -> dict:
    """Phase 16 (b)'s part on one rank, in a :func:`tp_models_rank` process
    of its own: phase 14's cells of DPM_ARCHS under "dp" on the
    (1, TPZ_RANKS) mesh, bf16 then fp32, the decode teacher-forced with 14
    (a)'s tokens; then their train cells, held to 14 (a)'s files (read from
    its work directory); rank 0 writes the logits."""
    import numpy as np

    ref = work.parent / "tp_zoo"
    report = {"rank": rank, "coordinate": list(mesh.get_coordinate()), "serve": {},
              "train": {}}
    for arch in DPM_ARCHS:
        forced = torch.from_numpy(np.load(ref / f"tokens_{arch}.npy"))
        for name, dtype, steps in (("", "bfloat16", TPZ_DECODE_STEPS),
                                   ("32", "float32", TPZ_FP32_STEPS)):
            rep, logits, _ = tpz_serve(torch, K, FK, mesh, arch, forced=forced,
                                       cf=TPZ_NODROP_CF.get(arch), dtype=dtype, steps=steps,
                                       parallelism="dp")
            torch.save(rep.pop("routes"), work / f"routes{name}_{arch}_rank{rank}.pt")
            if name:
                report["serve"][arch]["float32"] = rep
            else:
                report["serve"][arch] = rep
            if rank == 0:
                np.save(work / f"ranks_logits{name}_{arch}.npy",
                        torch.stack([lg.float() for lg in logits]).cpu().numpy())
            del logits
    # each rank computes the replicated layers whole: their bits stay equal
    # across the ranks only under deterministic kernels (the backward of
    # GQA's KV expansion adds with atomics otherwise)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch in DPM_ARCHS:
            report["train"][arch] = tpz_train_rank(torch, K, mesh, arch, work, rank,
                                                   dpm_train_cell, "examples_dp_moe",
                                                   ref_work=ref)
    finally:
        torch.use_deterministic_algorithms(False)
    report["deterministic_algorithms"] = "train"
    return report


# phases 14, 15 and 16's parts, by work directory under build/dist: (a)'s,
# (b)'s (phase 16 (b) is held to phase 14's (a))
TP_MODEL_PARTS = {"tp_zoo": (tpz_single_part, tpz_rank_part),
                  "tp_rest": (tpr_single_part, tpr_rank_part),
                  "dp_moe": (None, dpm_rank_part)}


def tp_models_single(_rank, store, work_root):
    """(a) of phases 14 and 15 in a process of its own, under NCCL at world
    size 1 (a (1, 1) mesh): each part in turn writes its report (with its
    own wall time) to ``single.json`` in its work directory."""
    import os

    # cuBLAS's reproducible workspace, for the train parts' deterministic
    # algorithms: set before the first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist

    K = tpt_process(torch)
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    init_process_group("cuda", f"file://{store}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh("cuda", model=1)
        for name, (part, _) in TP_MODEL_PARTS.items():
            if part is None:
                continue
            work = Path(work_root) / name
            t0 = time.perf_counter()
            report = part(torch, K, FK, mesh, work)
            report["wall_s"] = time.perf_counter() - t0
            (work / "single.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def tp_models_rank(rank, world, store, work_root, names):
    """(b) of phases 14 to 16: one of ``world`` gloo ranks sharing the one
    card, a (1, world) ``(data, model)`` mesh; each part of ``names`` in turn
    writes the rank's report (with its own wall time) to ``rank<r>.json``.  The
    allocator grows its segments in place (``expandable_segments``): phase
    16's ranks each hold a whole training state of ~39 GB, and the card's
    memory is shared.  cuBLAS's reproducible workspace is set for phase 16's
    deterministic train cells."""
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # cuBLAS's reproducible workspace, for phase 16's deterministic train
    # cells: set before the first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from torch.distributed.device_mesh import init_device_mesh

    K = tpt_process(torch)
    from repro_torch.kernels.flash_attention import kernel as FK

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=600))
    try:
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        for name in names:
            part = TP_MODEL_PARTS[name][1]
            work = Path(work_root) / name
            t0 = time.perf_counter()
            report = part(torch, K, FK, mesh, work, rank)
            report["wall_s"] = time.perf_counter() - t0
            (work / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def phase_tensor_parallel_models(torch):
    """Phases 14 and 15 (:func:`phase_tensor_parallel_zoo`,
    :func:`phase_tensor_parallel_rest`), and phase 16 (b): 14's and 15's
    flash_attention cases in this process, then their (a) parts in one
    spawned process and their (b) parts in one spawn of TPZ_RANKS ranks, so
    each process's start-up is paid once; then phase 16 (b) in a spawn of
    TPZ_RANKS ranks of its own (its ranks each hold a whole training state:
    what 14's and 15's parts leave in a process would not fit beside it);
    then 14's and 15's holds and lines.  Returns the two phases' results and
    the spawned processes' times (phase 16 holds its part later)."""
    import gc

    import torch.multiprocessing as mp

    work_root = ROOT / "build" / "dist"
    outs = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for name, cases in (("tp_zoo", TPZ_FLASH_CASES), ("tp_rest", TPR_FLASH_CASES)):
        (work_root / name).mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        outs[name] = {"card": card_name_power(), "head_offset": tp_flash_cases(torch, flush, cases)}
        outs[name]["flash_cases_s"] = time.perf_counter() - t0
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    stores = {k: work_root / f"tp_models_{k}_store" for k in ("nccl", "gloo", "gloo_dp")}
    for store in stores.values():
        store.unlink(missing_ok=True)
    (work_root / "dp_moe").mkdir(parents=True, exist_ok=True)
    # what this process keeps on the card while the spawned ranks run
    held_here = {"script_process_allocated_bytes": torch.cuda.memory_allocated(),
                 "card_free_bytes_at_spawn": torch.cuda.mem_get_info()[0]}
    t0 = time.perf_counter()
    mp.start_processes(tp_models_single, args=(str(stores["nccl"]), str(work_root)), nprocs=1,
                       start_method="spawn", join=True)
    t1 = time.perf_counter()
    mp.start_processes(tp_models_rank, args=(TPZ_RANKS, str(stores["gloo"]), str(work_root),
                                             ("tp_zoo", "tp_rest")),
                       nprocs=TPZ_RANKS, start_method="spawn", join=True)
    t2 = time.perf_counter()
    mp.start_processes(tp_models_rank, args=(TPZ_RANKS, str(stores["gloo_dp"]), str(work_root),
                                             ("dp_moe",)),
                       nprocs=TPZ_RANKS, start_method="spawn", join=True)
    spawned = {"world_size_1_process_s": t1 - t0, "gloo_ranks_processes_s": t2 - t1,
               "dp_gloo_ranks_processes_s": time.perf_counter() - t2,
               "note": "the phases' parts (14 and 15; 16 (b)) and each process's start-up",
               **held_here}
    zoo = phase_tensor_parallel_zoo(torch, work_root / "tp_zoo", outs["tp_zoo"], spawned)
    rest = phase_tensor_parallel_rest(torch, work_root / "tp_rest", outs["tp_rest"], spawned)
    return zoo, rest, spawned


def tpr_flash_expected(cfg, image=False) -> tuple:
    """(flash_attention launches of one prefill, its route): the
    self-attention of each decoder layer on the kernel route, an encoder's
    and the cross-attention's too; none on the plain route (qwen2-vl's image
    block) or without attention (xLSTM)."""
    if not any(seg.has_attention for seg in cfg.decoder_plan()):
        return 0, None
    if image:
        return 0, "plain"
    return (cfg.enc_layers + 2 * cfg.num_layers if cfg.is_encdec else cfg.num_layers), "kernel"


def phase_tensor_parallel_rest(torch, work, out, spawned):
    """Phase 15's holds and line: the xLSTM, qwen2-vl and seamless cells
    tensor-parallel over ``model`` at full width (TPR_SERVE, TPR_TRAIN), and
    qwen2-1.5b's decode cell with its cache split by KV heads, each part run
    in processes of its own with phase 14's
    (:func:`phase_tensor_parallel_models`), its results under ``work``;
    ``out`` holds ``flash_attention`` on rank 1's heads at (b)'s prefill
    shapes (TPR_FLASH_CASES: non-causal, and Sq != Sk); ``seconds`` as
    phase 14's.  (a) Under
    NCCL at world size 1: the prefill and decode cells bitwise
    ``T.prefill`` / ``T.decode_step``, the train cell bitwise
    ``train_step`` (under deterministic algorithms); then the same weights
    and tokens computing in fp32.  (b) Over TPZ_RANKS gloo ranks sharing the
    card, fed (a)'s tokens, held to (a) with phase 14's limits:

    * fp32: logits within TPZ_FP32_ROW_TOL (row norm), m after step 1
      within TPZ_FP32_M_TOL of (a)'s slice, per leaf;
    * bf16: logits within TP_LOGITS_ROW_TOL or twice (a)'s own bf16 error
      (against its fp32 run), whichever is larger; each fed token within
      TOL of (a)'s top logit; train losses within TPT_LOSS_REL_TOL, grad
      norms within TPT_GNORM_REL_TOL; m after step 1 within TPT_M_REL_TOL
      of (a)'s slice or twice (a)'s own bf16 error, per leaf; replicated
      leaves bitwise across the ranks.

    Every prefill's flash_attention launches (:func:`tpr_flash_expected`)
    hopper at the rank's head offset, its route counted; (b)'s qwen2-1.5b
    decode cache split by KV heads, the others' by sequence.  (b)'s times
    are gloo's.  Returns the launches of (a) and of each rank, by model, and
    the flash_attention cases."""
    import numpy as np

    t_phase = time.perf_counter()
    one = out["world_size_1"] = json.loads((work / "single.json").read_text())
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TPZ_RANKS)]
    wall = max(rep["wall_s"] for rep in ranks)
    held, failures = {}, []

    def hold(cond, msg):
        if not cond:
            failures.append(msg)

    def flash_ok(s, cfg, image, offset):
        n, route = tpr_flash_expected(cfg, image)
        routes = {"kernel": int(route == "kernel"), "plain": int(route == "plain")}
        return (s["launches"]["flash_attention"] == n
                and s["flash_attention_variants"] == {"hopper": n, "generic": 0}
                and s["flash_attention_calls_by_head_offset"] == ({str(offset): n} if n else {})
                and s["prefill_routes"] == routes)

    for arch in TPR_SERVE:
        cfg = tpr_config(arch, "serve")
        per = cfg.padded_heads // TPZ_RANKS
        load = lambda name: torch.from_numpy(np.load(work / f"{name}_{arch}.npy"))  # noqa: E731
        want, got = load("logits"), load("logits_ranks")
        want32, got32 = load("logits32"), load("logits32_ranks")
        n32 = 1 + TPZ_FP32_STEPS
        errs, errs32 = row_errs(torch, got, want), row_errs(torch, got32, want32)
        own = row_errs(torch, want[:n32], want32).max().item()
        limit = max(TP_LOGITS_ROW_TOL, 2 * own)
        tol = TOL["bfloat16"]
        mine, top = got.argmax(-1), want.max(-1).values
        gap = top - want.gather(-1, mine[..., None])[..., 0]
        hold(errs.max().item() <= limit,
             f"tensor_parallel_rest (b) {arch}: logits row errors {errs.tolist()} over {limit}")
        hold(errs32.max().item() <= TPZ_FP32_ROW_TOL,
             f"tensor_parallel_rest (b) {arch} fp32: logits row errors {errs32.tolist()}")
        hold(bool((gap <= tol["atol"] + tol["rtol"] * top.abs()).all()),
             f"tensor_parallel_rest (b) {arch}: a fed token is {gap.max().item()} below (a)'s "
             "top logit")
        a = one["serve"][arch]
        hold(flash_ok(a, cfg, False, 0),
             f"tensor_parallel_rest (a) {arch}: {a['launches']}, {a['flash_attention_variants']}, "
             f"{a['flash_attention_calls_by_head_offset']}, {a['prefill_routes']}")
        for r, rep in enumerate(ranks):
            s = rep["serve"][arch]
            hold(flash_ok(s, cfg, False, r * per),
                 f"tensor_parallel_rest (b) {arch} rank {r}: {s['launches']}, "
                 f"{s['flash_attention_variants']}, "
                 f"{s['flash_attention_calls_by_head_offset']}, {s['prefill_routes']}")
            spec = s.get("decode_kv_spec")
            if spec is not None:
                by_heads = arch == TPR_HEAD_CACHE
                hold(spec[3 if by_heads else 2] == "model" and spec[2 if by_heads else 3] is None,
                     f"tensor_parallel_rest (b) {arch}: decode cache spec {spec}")
        held[arch] = {"logits_row_err": errs.max(-1).values.tolist(), "limit": limit,
                      "bf16_own_row_err": own,
                      "greedy_tokens_equal": int((mine == want.argmax(-1)).sum()),
                      "greedy_tokens": mine.numel(),
                      "float32_logits_row_err": errs32.max().item(),
                      "decode_kv_spec": ranks[0]["serve"][arch].get("decode_kv_spec")}
        if arch == TPR_VLM:
            w, g = load("image"), load("image_ranks")
            w32, g32 = load("image32"), load("image32_ranks")
            e, e32 = row_errs(torch, g, w).max().item(), row_errs(torch, g32, w32).max().item()
            own_i = row_errs(torch, w, w32).max().item()
            lim = max(TP_LOGITS_ROW_TOL, 2 * own_i)
            hold(e <= lim and e32 <= TPZ_FP32_ROW_TOL,
                 f"tensor_parallel_rest (b) {arch} image block: logits row errors {e} (limit "
                 f"{lim}), fp32 {e32}")
            hold(flash_ok(a["image"], cfg, True, 0)
                 and all(flash_ok(rep["serve"][arch]["image"], cfg, True, 0) for rep in ranks),
                 f"tensor_parallel_rest {arch} image block: not the plain route alone")
            held[arch]["image_block"] = {"logits_row_err": e, "limit": lim,
                                         "bf16_own_row_err": own_i, "float32_logits_row_err": e32}
    hold_train_ranks(torch, one, ranks, TPR_TRAIN, "tensor_parallel_rest", hold, held)
    out["gloo_ranks"] = {"ranks": ranks, "wall_s": wall, "held": held,
                         "note": "gloo stages every collective through the host: these "
                                 "times are not NVLink's; collectives counted over groups "
                                 "of more than one rank"}
    out["seconds"] = (out["flash_cases_s"] + one["wall_s"] + wall
                      + time.perf_counter() - t_phase)
    out["shared_processes"] = spawned
    out["failures"] = failures
    emit({"phase": "tensor_parallel_rest", **out})
    check(not failures, "tensor_parallel_rest: " + "; ".join(failures))
    return ({arch: s["launches"] for arch, s in one["serve"].items()},
            [{arch: s["launches"] for arch, s in rep["serve"].items()} for rep in ranks],
            out["head_offset"])


# ----------------------------------------------------------------- phase 16


def host_cpu() -> str:
    """The host's CPU model and logical CPU count (host-only numbers name it)."""
    import os
    import platform

    model = platform.processor() or platform.machine() or "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} logical CPUs"


def run_example(torch, K, FK, module, argv) -> dict:
    """``module.main(argv)`` with its standard output captured, the launch
    counts zeroed just before and read just after, the card's peak from its
    start; its lines, seconds, launches, variants and peak.  A failed
    assertion of the example raises."""
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    FK.reset_variant_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  [{module.__name__.rsplit('.', 1)[-1]}] {line[:400]}", flush=True)
    check(rc == 0, f"examples_dp_moe (a) {module.__name__}: exit code {rc}")
    return {"argv": argv, "seconds": seconds, "lines": lines[-4:],
            "launches": dict(K.launch_counts),
            "flash_attention_variants": dict(FK.variant_counts),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_examples_dp_moe(torch, K, FK, spawned):
    """Phase 16: (a) the ported example scripts on the card, in this
    process (:func:`run_example`): each ends with its own closing line, so
    its own assertion held (``paged-decode cross-check OK``: the engine's
    tokens are contiguous decode's; ``train_smollm OK``: the loss fell;
    ``quickstart OK``; the sort's runs descending); serve_paged launched
    paged_attention, page_scatter and flash_attention.  (b) The dp MoE
    cells of DPM_ARCHS, run in ranks of their own (:func:`dpm_rank_part`),
    held to phase 14's (a) as 14 holds its (b):
    :func:`hold_serve_ranks` (every rank on all heads: head offset 0) and
    :func:`hold_train_ranks`; every rank's prefill collectives hold the
    MoE's over ``model`` (TP-MoE's sum, EP's two all-to-alls a layer).
    (b)'s times are gloo's.  Returns (a)'s launches by example and (b)'s
    by rank and model."""
    from repro_torch.examples import out_of_core_sort, quickstart, serve_paged, train_smollm

    t_phase = time.perf_counter()
    out = {"card": card_name_power()}
    failures = []

    def hold(cond, msg):
        if not cond:
            failures.append(msg)

    ex = out["examples"] = {}
    ex["serve_paged"] = run_example(torch, K, FK, serve_paged, [])
    ex["train_smollm"] = run_example(torch, K, FK, train_smollm,
                                     ["--full", "--steps", str(EX_TRAIN_STEPS)])
    ex["quickstart"] = run_example(torch, K, FK, quickstart, [])
    ex["out_of_core_sort"] = run_example(torch, K, FK, out_of_core_sort,
                                         ["--mb", str(EX_SORT_MB),
                                          "--buffer-mb", str(EX_SORT_BUFFER_MB)])
    ex["out_of_core_sort"]["host_cpu"] = host_cpu()
    ex["out_of_core_sort"]["note"] = "the paging core runs on the host: host times"
    for name, last in (("serve_paged", "paged-decode cross-check OK"),
                       ("train_smollm", "train_smollm OK"), ("quickstart", "quickstart OK"),
                       ("out_of_core_sort", "first run descending: True")):
        check(ex[name]["lines"][-1] == last,
              f"examples_dp_moe (a) {name}: last line {ex[name]['lines'][-1]!r}")
    launched = ex["serve_paged"]["launches"]
    check(all(launched[k] > 0 for k in ("paged_attention", "page_scatter", "flash_attention")),
          f"examples_dp_moe (a) serve_paged: launches {launched}")
    out["examples_s"] = time.perf_counter() - t_phase

    t_b = time.perf_counter()
    work_root = ROOT / "build" / "dist"
    work = work_root / "dp_moe"
    one = json.loads((work_root / "tp_zoo" / "single.json").read_text())
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TPZ_RANKS)]
    held = {}
    for arch in DPM_ARCHS:
        cfg = tpz_config(arch, "serve", parallelism="dp")
        held[arch] = hold_serve_ranks(torch, arch, cfg, one, ranks, work_root / "tp_zoo", work,
                                      "examples_dp_moe", hold, 0)
        expect = "all_to_all_single" if cfg.moe_sharding == "ep" else "all_reduce"
        for r, rep in enumerate(ranks):
            calls = rep["serve"][arch]["prefill_collectives"]
            hold(calls.get(expect, {}).get("calls", 0) >= cfg.num_layers,
                 f"examples_dp_moe (b) {arch} rank {r}: prefill collectives {calls}")
    hold_train_ranks(torch, one, ranks, DPM_ARCHS, "examples_dp_moe", hold, held)
    wall = max(rep["wall_s"] for rep in ranks)
    out["dp_moe"] = {"world_size_1": "phase 14's (a): the same program at world size 1",
                     "gloo_ranks": {"ranks": ranks, "wall_s": wall, "held": held},
                     "note": "gloo stages every collective through the host: these times "
                             "are not NVLink's; collectives counted over groups of more "
                             "than one rank"}
    out["seconds"] = out["examples_s"] + wall + time.perf_counter() - t_b
    out["shared_processes"] = spawned
    out["failures"] = failures
    emit({"phase": "examples_dp_moe", **out})
    check(not failures, "examples_dp_moe: " + "; ".join(failures))
    return ({name: e["launches"] for name, e in ex.items()},
            [{arch: s["launches"] for arch, s in rep["serve"].items()} for rep in ranks])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.models as M
    import repro_torch.serve.engine as engine_module
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.page_gather import kernel as CK

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32 (check phase)
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    reports = K.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in r.splitlines()
                        if "registers" in ln or "spill" in ln] for n, r in reports.items()},
          "page_copy_bulk_shape": CK.bulk_shape()})

    # 2. kernels against their plain versions
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kstats = phase_kernels(torch, flush)
    del flush

    # the dry run's 66 records execute on meta in niced children from here
    # on (phase 11 collects them); the pool's children are daemons, ended
    # with the script whatever way it ends
    dry = start_dry_run()

    # 3. the main path
    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    serve(torch, cfg, params, 2, seed=7)               # warm-up: cuBLAS, allocator
    K.reset_launch_counts()
    CK.reset_copy_variant_counts()
    with InstallTimer(engine_module) as installs:
        eng, reqs, seconds = serve(torch, cfg, params, 16, seed=0)
    launches = dict(K.launch_counts)
    copy_variants = copy_variants_now()
    tokens = sum(len(r.generated) for r in eng.finished)
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "init_params_s": init_s, "requests_served": len(eng.finished), "tokens": tokens,
          "seconds": seconds, "tok_per_s": tokens / seconds, "steps": eng.stats["steps"],
          "prefills": eng.stats["prefills"], "cow_copies": eng.stats["cow_copies"],
          "prefix_hits": eng.stats["prefix_hits"], "launches": launches,
          "copy_variants": copy_variants,
          "copy_launch_bounds": check_copy_launches("serve", launches, copy_variants, eng),
          "install_host_ms": installs.summary()})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(eng.stats["cow_copies"] > 0 and eng.stats["prefix_hits"] > 0,
          "the prefix request did not share pages / copy on write")

    # 4. outputs: bf16 logits margin, fp32 exact greedy tokens
    cow_req = reqs[-1]
    _, logits = contiguous_decode(torch, M, cfg, eng.params, cow_req.prompt, 16,
                                  forced=cow_req.generated)
    tol = TOL["bfloat16"]
    margins = []
    for step, (lg, tok) in enumerate(zip(logits, cow_req.generated)):
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
        top = lg.max()
        gap = (top - lg[tok]).item()
        margins.append(gap)
        check(gap <= tol["atol"] + tol["rtol"] * abs(top.item()),
              f"bf16 step {step}: paged token {tok} is {gap} below the contiguous max")
    cfg32 = cfg.replace(compute_dtype="float32")
    eng32, reqs32, _ = serve(torch, cfg32, params, 3, seed=3)
    for r in reqs32:
        ref, _ = contiguous_decode(torch, M, cfg32, params, r.prompt, r.max_new_tokens)
        check(ref == r.generated, f"fp32 rid {r.rid}: paged {r.generated} != contiguous {ref}")
    emit({"phase": "check", "bf16_max_gap_to_top_logit": max(margins),
          "bf16_tokens_equal_to_contiguous_argmax": sum(m == 0.0 for m in margins),
          "fp32_requests_equal": len(reqs32), "fp32_cow_copies": eng32.stats["cow_copies"]})

    # 5. where a decode step's time goes (bf16, 8 lanes)
    phase_profile(torch, cfg, eng.params)
    del eng, eng32, params
    torch.cuda.empty_cache()

    # 6. long prompts on full-width qwen2-1.5b (the prefill path)
    long_launches, flash_variants, long_copy_variants, qwen2 = phase_long_prompt(torch, M, K)

    # 7. the same weights streamed from a host region (the weight pager)
    weight_launches, weight_copy_variants = phase_weight_pager(
        torch, K, get_config("qwen2-1.5b"), qwen2)
    del qwen2
    torch.cuda.empty_cache()

    # 8. training: full-width smollm-135m, the resident Trainer and the
    # out-of-core OOCTrainer (its grad phase streams through the page copies)
    train_launches, train_copy_variants, handoff = phase_train(torch, K, CK)

    # 9. the MoE and hybrid decoders, and llama3-8b / deepseek-7b, served at
    # full width (the MoE models' depth cut)
    zoo_launches = phase_zoo(torch, M, K)

    # 10. the rest of the zoo: xlstm-1.3b served, qwen2-vl-7b's embeddings
    # path and seamless-m4t-medium's encoder-decoder, at full width
    rest = phase_zoo_rest(torch, M, K)
    rest_launches = {a: c["launches"] for a, c in rest.items()}

    # 11. distribution under NCCL at world size 1: the dry run of every
    # cell, the data-parallel ZeRO-1 train cell, the int8 reduction,
    # shard-local MoE, the elastic restore and qwen2-1.5b's prefill cell
    from repro_torch.kernels.flash_attention import kernel as FK
    dist_launches, dist_logits = phase_distributed(torch, K, FK, handoff, dry)
    del handoff

    # 12. tensor parallelism: flash_attention's head offset at full width,
    # qwen2-1.5b's prefill and decode cells on the TP code path at world
    # size 1 (NCCL) and over 2 gloo ranks sharing the one card
    tp_launches, tp_cases, tp_rank_launches = phase_tensor_parallel(torch, K, FK, dist_logits)
    del dist_logits

    # 13. the train cell tensor-parallel: full-width qwen2-1.5b (14 of 28
    # layers) at world size 1 (NCCL, bitwise train_step) and over 2 gloo
    # ranks sharing the one card
    tpt_launches, tpt_rank_launches = phase_tensor_parallel_train(torch, dry[0])
    dry[0].terminate()
    dry[0].join()

    # 14. the MoE and hymba cells tensor-parallel: mixtral-8x7b (TP-MoE),
    # phi3.5-moe (EP) and hymba-1.5b (its Mamba mixer split) at full width,
    # prefill, decode and train, at world size 1 (NCCL, bitwise) and over 2
    # gloo ranks sharing the one card; 15. the same for the xLSTM, qwen2-vl
    # and seamless cells: xlstm-1.3b (its mLSTM channels split), qwen2-vl-7b
    # (M-RoPE) and seamless-m4t-medium (the encoder and cross-attention),
    # and qwen2-1.5b's decode cache split by KV heads; the two phases' parts
    # share their processes
    ((tpz_launches, tpz_rank_launches, tpz_cases),
     (tpr_launches, tpr_rank_launches, tpr_cases), spawned) = phase_tensor_parallel_models(torch)

    # 16. the JAX package's example scripts, ported, on the card; and the
    # shard-local MoE under parallelism="dp" over 2 gloo ranks (run in the
    # processes of 14 and 15), mixtral-8x7b (TP-MoE) and phi3.5-moe (EP)
    ex_launches, dpm_rank_launches = phase_examples_dp_moe(torch, K, FK, spawned)

    # launches: each kernel's count on the path that carries it (decode
    # kernels on the serve phase, flash_attention on the long-prompt phase)
    rows = []
    for name in ("paged_attention", "page_gather", "page_scatter", "flash_attention"):
        s = kstats[name]
        counted = long_launches if name == "flash_attention" else launches
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": counted[name],
               "launches_by_path": {"serve": launches[name],
                                    "long_prompt": long_launches[name],
                                    "weight_pager": weight_launches[name],
                                    "train": train_launches[name],
                                    "zoo": {a: n[name] for a, n in zoo_launches.items()},
                                    "zoo_rest": {a: n[name] for a, n in rest_launches.items()},
                                    "distributed": dist_launches[name],
                                    "tensor_parallel": tp_launches[name],
                                    "tensor_parallel_gloo_ranks": [
                                        n[name] for n in tp_rank_launches],
                                    "tensor_parallel_train": {
                                        "world_size_1": tpt_launches[name],
                                        "gloo_ranks": [n[name] for n in tpt_rank_launches]},
                                    "tensor_parallel_zoo": {
                                        "world_size_1": {a: n[name]
                                                         for a, n in tpz_launches.items()},
                                        "gloo_ranks": [{a: n[name] for a, n in r.items()}
                                                       for r in tpz_rank_launches]},
                                    "tensor_parallel_rest": {
                                        "world_size_1": {a: n[name]
                                                         for a, n in tpr_launches.items()},
                                        "gloo_ranks": [{a: n[name] for a, n in r.items()}
                                                       for r in tpr_rank_launches]},
                                    "examples": {e: n[name] for e, n in ex_launches.items()},
                                    "examples_dp_moe_gloo_ranks": [
                                        {a: n[name] for a, n in r.items()}
                                        for r in dpm_rank_launches]},
               "max_abs_err": s["max_abs_err"], "ms": s["ms"],
               "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
               "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        if name in kstats["zoo_cases"]:
            # phase 9's shapes: each case with its model's launches there
            model_of = ZOO_PAGED_CASES if name == "paged_attention" else ZOO_FLASH_CASES
            # (paged_attention: its windowed launches in that model's run)
            counted = "paged_attention_windowed" if name == "paged_attention" else name
            by_model = {**zoo_launches, **rest_launches}
            row["zoo_cases"] = [
                {"case": c["case"], "dtype": c["dtype"], "window": c["window"],
                 "model": model_of[c["case"]],
                 "launches": by_model[model_of[c["case"]]][counted],
                 **{k: c[k] for k in ("max_abs_err", "max_row_rel_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}}
                for c in kstats["zoo_cases"][name]]
        if name == "flash_attention":
            # the variant the main path took, and each variant's time at
            # the main-path shape (qwen2's 4096-token prompt, bf16)
            row["variant"] = s["variant"]
            row["variants"] = {v: {"ms": ms, "long_prompt_launches": flash_variants[v]}
                               for v, ms in s["variant_ms"].items()}
            # phase 10: launches by model, by variant and by mask, and the
            # prefills that took the plain route
            row["zoo_rest"] = {a: {k: c[k] for k in ("flash_attention_variants",
                                                     "flash_attention_calls", "prefill_routes")}
                               for a, c in rest.items()}
            row["plain_route_prefills"] = sum(c["prefill_routes"]["plain"]
                                              for c in rest.values())
            # phase 12 (a): one rank's heads (head_offset) at full width; the
            # launches are phase 12 (c)'s on the rank that shard stands for
            # and phase 14's: their launches are rank 1's in phase 14 (b)
            def launches_of(c):
                if c["case"] == "qwen2_4096_tp2":
                    return tp_rank_launches[1]["flash_attention"]
                if c["case"] in TPZ_FLASH_ARCH:
                    return tpz_rank_launches[1][TPZ_FLASH_ARCH[c["case"]]]["flash_attention"]
                if c["case"] in TPR_FLASH_ARCH:
                    return tpr_rank_launches[1][TPR_FLASH_ARCH[c["case"]]]["flash_attention"]
                return None

            row["tensor_parallel_cases"] = [
                {"case": c["case"], "dtype": c["dtype"], "q": c["q"], "window": c["window"],
                 "causal": c["causal"], "kv_len": c["kv_len"],
                 "head_offset": c["timed_offset"], "variant": c["variant"],
                 "launches": launches_of(c),
                 "full_launch_ms": c["full_launch_ms"],
                 "full_launch_share_ms": c["full_launch_share_ms"],
                 **{k: c[k] for k in ("max_abs_err", "max_row_rel_err", "ms", "generic_ms",
                                      "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                for c in tp_cases + tpz_cases + tpr_cases]
        if name in COPY_MAIN_CASE:
            # the serve path's call (both pools, every layer: two launches),
            # the parent's call pattern for it, and the launches by variant
            row["case"] = s["case"]
            row["parent_ms"] = s["parent_ms"]
            row["copy_variants"] = {"serve": copy_variants[name],
                                    "long_prompt": long_copy_variants[name],
                                    "weight_pager": weight_copy_variants[name],
                                    "train": train_copy_variants[name]}
            # the weight path's call: one layer of 47 2 MiB pages, [P, E]
            w = next(r for r in kstats["weight_copies"] if r["name"] == name)
            row["weight_pager_case"] = {k: w[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "variant_ms")}
        rows.append(row)
    emit({"kernels": rows})
    print(card_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
