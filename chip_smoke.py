"""Smoke run of the PyTorch port on one CUDA card: LTX-Video text-to-video serving,
the LTX-Video LoRA training step, Wan 2.1 T2V-1.3B serving under the int8
`sage` attention provider and the Wan 2.1 T2V-1.3B LoRA training step, with
every kernel switch of the flash attention, every remat policy, gradient
accumulation, checkpoint/resume and the LoRA export, the Wan example's
run through its command line, from videos on disk, and Wan 2.1 I2V-14B at
full width: LoRA training, then image-to-video serving through the inference
runner with the exported adapter and UniPC at 81x480x832, FLUX.1-dev at
full width: the flux_dev example's LoRA run through its command line at its
own 1280x720 bucket, then 1024x1024 text-to-image serving through the runner
with the exported adapter, HunyuanVideo at full width: the
modal_labs_dissolve example's LoRA run through its command line at its own
49x480x768 bucket, then 49x480x768 text-to-video serving through the runner
with the exported adapter, and CogView4-6B at full width with the control
trainer: the canny control-LoRA example's run through its command line at
1024x1024, a control-conditioned and a plain 1024x1024 request through the
runner, and the Wan image_condition control example's run, and CogVideoX-5B at
full width: its kernels at 30,466 tokens of head dim 64, the crush_smol_lora
example's DDIM LoRA run through its command line at its own 81x480x768 bucket,
then an 81x480x768 DDIM text-to-video request through the runner with the
exported adapter, the dummy family on the head-dim-32 instances of K1, the
pre-pass, K2 and K3 (LoRA and 8-bit-AdamW full-finetune runs, a request), and
CogView4-6B's raider_white_tarot example trained under int8 weight storage at
1280x720 and served with `--quantize_int8`, K1's dense-mask branch, the GLM-4,
Llama-3 and CLIP-L text towers at full width on it, CogView4 loaded from a
local diffusers directory (transformer, 2D AutoencoderKL, GLM-4) and served
(also under the `flex` provider), and the causal, packed-segment and
dense-mask branches of K1, K2 and K3 through `attention_dispatch` at Wan's,
Llama-3's and CogView4's widths.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the nvcc builds of the hand-written kernels, one process per source, all
     started together: K1 and K7a/b/c (`csrc/flash_fwd_sm90.cu`, wgmma and
     TMA), K2, K3 and K5 (`csrc/flash_bwd_sm90.cu`, wgmma and TMA, with K2's
     reduce pass for a split q loop, which K5 shares), K5's dq emit and the
     pre-pass that every forward but K7b and every backward runs first
     (`csrc/flash_bwd.cu`) and K6 with its pre-pass (`csrc/sage_fwd_sm90.cu`,
     int8 wgmma and TMA), timed, with ptxas' register, spill and warning
     lines; a spill in any of the eight wgmma kernels (K1, K2, K3, K5, K6,
     K7a, K7b, K7c) fails the run;
  3. K1 against its plain PyTorch version (`flash_forward_core_reference` on
     the pre-pass's operands) and the pre-pass plus K1 (`flash_forward`)
     against `flash_attention_reference`, in bf16, at the LTX serving path's
     shapes (self-attention with per-head tables, cross-attention with
     kv_lens, a ragged case with an empty row whose k/v rows past kv_lens hold
     large values) and Wan's cross-attention shapes, with errors and median
     CUDA-event times of K1 alone and of the pre-pass;
  4. K2, K3 and the pre-pass against `flash_backward_reference` in bf16 at the
     training paths' shapes (LTX self-attention with per-head RoPE tables,
     cross-attention with kv_lens, a ragged case with an empty row, H=128 with
     shared tables, and Wan's training self-attention (1, 12, 19968, 128) with
     the shared Wan tables and cross-attention over 512 keys at full width,
     held one head at a time, and the same two at the example's 20280
     tokens), with errors, CUDA-event and device times of K2
     and K3 and of their plain versions (`flash_bwd_dkdv_reference`,
     `flash_bwd_dq_reference`), bounds and the torch SDPA backward as a
     library yardstick;
  5. the sage pre-pass kernel (`sage_prep`: rotation with Wan's tables,
     smooth-K, int8 codes) against the plain pre-pass on the CPU, and K6 against
     `sage_attention_reference` on the same int8 codes and scales (Wan
     self-attention with the tables, Wan cross-attention over 512 text keys
     with kv_lens, LTX's self-attention shape, ragged cases with an empty row
     at H=128 and H=64); times of K6, the pre-pass, the plain pre-pass (torch's
     rotation and quantization on the card) and K6's plain version, the bounds
     and torch SDPA as a yardstick; then K1 at Wan's self-attention shapes (H=128,
     one (S, H) table pair shared by every head; serving, and the example's
     20280 tokens whose last tiles hold 56 rows) against its plain version,
     run head by head, timed alone and with its pre-pass;
  5b. K5 and its dq emit against K5's plain version and against K2+K3 (pre-pass
     included) at LTX's train self-attention with per-head tables, LTX's
     cross-attention, a ragged case with an empty row and Wan's training
     self-attention (1, 12, 19968, 128) with shared tables: errors, times of
     K5, the emit, K1, K2, K3 and both whole backwards, bounds, and the torch
     SDPA backward as the library yardstick; then K7a, K7b and K7c each
     against its plain version and against K1 at LTX's serving self-attention,
     Wan's self-attention (B=1 and 2, shared tables; K7b without tables),
     Wan's cross-attention (512 keys, kv_lens, B=1 and 2) and a ragged case
     with an empty row, where k/v rows past kv_lens holding large values must
     leave out and LSE bit-equal;
  6. LTX serving through the user entry points: the full-width LTX spec (random
     weights from a seeded generator, bf16) serves 2 prompts at 49x512x768 with
     CFG 3.0; checks the videos and that K1 and the pre-pass were each launched
     2*28*steps*requests times and no other kernel;
     then one denoise step with K1 against plain fp32 attention, seconds per step
     and per request, peak memory, and a torch.profiler breakdown of one step;
  7. Wan serving through the user entry points: the full-width Wan 2.1
     T2V-1.3B spec (random weights, bf16, 30 blocks) serves 2 prompts at
     49x512x768 with CFG 5.0 and 4 steps under `attention_provider("sage")`:
     checks the videos, that the sage pre-pass and K6 were each launched
     2*30*steps*requests times, K1 never, and that nothing rotated q or k in
     torch; one request under the default provider (K1 and the pre-pass,
     2*30*steps launches each); one denoise step with K6 against the same step
     with K1;
     seconds per step and per request, peak memory, and a torch.profiler
     breakdown of one sage step (K6 and its pre-pass, self and cross, GEMMs,
     the rest) and of one K1 step (K1 and its pre-pass, self and cross, GEMMs,
     the rest);
  8. training through the user entry points: `SFTTrainer.train` on the full-width
     spec with LoRA rank 128, one warm-up and 3 timed steps on seeded VAE
     moments (1, 256, 7, 16, 24) -> 2688 tokens and seeded caption states with
     a padded mask, then its final checkpoint and adapter export; checks finite
     losses, moved LoRA factors, unchanged frozen weights, the checkpoint and
     2*28 launches of K1, K2 and K3 and 4*28 of the pre-pass (forward and
     backward) per step; K4's host cost (`train_k4_host_cost`: train steps
     and one host-bound call with the port's K4, with PRs 2-9's
     autograd.Function and with a torch.library.custom_op, all over the same
     kernels, interleaved); then one step's loss and LoRA gradient with the
     kernels against plain fp32 attention (both under per-block "full" remat),
     and a torch.profiler breakdown of one train step;
  9. Wan LoRA training through the user entry points: `SFTTrainer` on the
     full-width Wan 2.1 T2V-1.3B spec (rank 32, the optimizer of
     examples/training/sft/wan/crush_smol_lora/train.sh, logit-normal
     weighting, per-block "full" remat) on seeded VAE moments (1, 32, 13, 64,
     96) -> 19968 tokens and 512 valid caption tokens: one warm-up and 2 timed
     steps through `train` (finite losses, moved LoRA factors, unchanged frozen
     weights, K1 4*30, the pre-pass 4*30 + 2*30, K2 and K3 2*30 launches per
     step, model TFLOP/s by tools/floor_bench.py's formula); the same step under
     FINETRAINERS_FLASH_FUSED_BWD (K5: bit-equal loss, LoRA gradient within
     1e-2, 2*30 K5 launches, 1 timed step) and under each forward switch
     (K7a/b/c launch counts, loss within 1e-3 and gradient within 2e-2 of the
     K1 step), then 1 timed step under each of FINETRAINERS_FLASH_TWOPASS
     (K7a), _TWOLEVEL (K7c) and _SKEW (K7b), with exact launch counts;
     the kernel step against plain fp32 attention at 4992 tokens; the step
     under each remat policy, "full", "ops", "ops_attn" and "ops_narrow"
     (`wan_train_remat`: loss bit-equal and LoRA gradient within 2e-2 of
     "full"'s at the same weights, K1 2*30 launches under the selective
     policies, one warm-up and 1 timed step each with peak memory and model
     TFLOP/s at the policy's remat factor); host issue time and a
     torch.profiler breakdown of one "full" step;
  10. the Wan example's run (`wan_train_accum_resume`): "ops" remat, gradient
     accumulation over 2 micro-steps, a checkpoint every 2 with the 2 newest
     kept, 6 seeded batches: an unbroken run against one broken after 3
     micro-steps (a forced save in the middle of an accumulation) and resumed
     from "latest" by a fresh trainer and model: LoRA factors and AdamW moments
     bit-equal, equal loss histories, 3 applied updates each; then
     (`wan_lora_export`) the unbroken run's exported adapter in a fresh model
     with the same base weights reproduces the resumed model's forward,
     bit-equal;
  11. the Wan example's run through its command line (`wan_run`):
     `finetrainers_tpu_torch.train.main` with train.sh's own flags (one card's
     parallel layout, `--report_to jsonl`, 4 steps with a checkpoint every 2
     and validation at 4, 2 precomputed items, the output under build/) on 2
     seeded videos it writes with cv2 at the example's 49x480x832 bucket
     (20280 tokens): precompute once (decode, bucket, tiled and sliced VAE
     encode, text states), `transformer:ring`, "ops" remat, validation through
     `WanPipeline` (2 denoising steps, cut from 50). The same run broken after
     2 steps and resumed from "latest" must end with LoRA factors and AdamW
     moments bit-equal to the unbroken one's, after the same sample ids each
     step. Each step launches K1 60 times, the pre-pass 120, K2 and K3 60, K2's
     reduce pass 30, and no other kernel; each validation K1 and the pre-pass
     120 times. Precompute seconds per item, step seconds, peak memory,
     validation seconds, a profile of one step (idle share) and steps under
     `transformer:ring` and `transformer:auto` in turns;
  12. Wan 2.1 I2V-14B at full width (`WAN_I2V_14B_CONFIG`: 40 blocks, 40 heads
     x 128, ffn 13824, in_channels 36, image_dim 1280; 16,419,458,624
     parameters, built on the card in bf16): `wan_i2v_train`, LoRA rank 32
     (179,568,640 trainable) with the example's optimizer and "full" remat on
     seeded moments, condition moments and mask at 49x480x832 (20280 tokens)
     and 512 caption tokens, one warm-up and one timed step through `train`
     (K1 160, the pre-pass 240, K2 and K3 80 launches a step and no reduce
     pass: K2 splits its q loop only where a call's kv-tile CTAs are fewer
     than the SMs, and 40 heads give 160), the adapter export and a profiled
     third step, after which every LoRA factor has moved; then
     `wan_i2v_serve`, one image-to-video request through
     `finetrainers_tpu_torch.inference.main` (a PNG first frame written with
     cv2, CFG 5.0, 2 UniPC steps of 50 read from a scheduler config written
     as the public I2V-14B-480P checkpoint names it, the exported adapter):
     a finite (81, 480, 832, 3) video, K1 and the pre-pass 80 times a step
     (the image branch is not wired, as in JAX), request, step, VAE encode and
     decode seconds and the peak; then `wan_i2v_image_branch`, a `WanPipeline`
     built with the image encoder: one step under `auto` (K1 120 a step, 40 of
     them over the 257 image keys) and one under `sage` (K6 120), each timed
     and profiled, the sage step within 0.1 of the auto step. The kernel
     checks above include the new shapes: K1 and K6 at (2, 40, 32760, 32760,
     128) (the sage pre-pass's codes there held against the plain pre-pass
     on the first and last heads) and (2, 40, 32760, 257, 128) with no
     kv_lens, K1 at the text cross shape with 40 heads, and K1, K2 and K3 at
     (1, 40, 20280, 20280, 128) and its 512-key cross shape;
  13. FLUX.1-dev at full width (`FLUX_TRANSFORMER_CONFIG`: 19 dual and 38
     single blocks, 24 heads x 128, 11,901,408,320 parameters, bf16):
     `flux_kernel_checks`, K1 and the pre-pass at the serving self-attention
     (1, 24, 4608, 4608, 128) and K1, the pre-pass, K2 and K3 at the
     training one (1, 24, 4112, 4112, 128, a last tile of 16 rows), with
     Flux's per-token tables (identity text rows), against their plain
     versions head by head, timed, with bounds and SDPA; `flux_run`,
     `python -m finetrainers_tpu_torch.train` with the flux_dev train.sh's
     flags (one card, `ops` remat, `transformer:auto`, rank 32) from 4 PNG
     images written with cv2 and bucketed to 1280x720 (4112 tokens): 4
     steps, K1 57, the pre-pass 114, K2 57 and K3 57 launches each and no
     reduce pass (24 heads x 33 kv tiles = 792 CTAs, over the 132 SMs), the
     final validation from the exported adapter (1 request, 2 steps of 50: K1
     and the pre-pass 114), step seconds, model TFLOP/s, peaks, precompute
     seconds per image, a profiled step after the run, then the step under
     `ops` and under `full` in turns, 1 each (`flux_run_policies`);
     `flux_serve`, one 1024x1024 request through `inference.main` with
     guidance 3.5, 4 Euler steps of 28 with dynamic shifting from a
     scheduler config written as the
     public FLUX.1-dev checkpoint names it, and that adapter: a finite (1024,
     1024, 3) image written as .png, the adapter's factors in the served
     model, K1 and the pre-pass 57 times a step and no other kernel, the
     VAE's largest activation under SPLIT_ELEMENTS (no strips), request,
     step and decode seconds, the peak and a profiled step;
  14. HunyuanVideo at full width (`HUNYUAN_VIDEO_CONFIG`: 20 dual and 40
     single blocks, the Flux blocks, 2 token-refiner blocks, 24 heads x 128,
     12,817,866,816 parameters, bf16): `hunyuan_kernel_checks`, K1 and the
     pre-pass, K2 and K3 at the joint self-attention (1, 24, 18976, 18976, 128,
     a last tile of 32 rows) with the frame-axis tables (identity text rows),
     head by head against their plain versions, and at the refiner's
     self-attention (1, 24, 256, 256, 128) with kv_lens [65] and (2, ...) with
     [65, 256], a dead second kv tile: K1 on every row, K2 with its q loop
     split in 2 and the reduce pass (B=1), dk = dv = 0 exactly past kv_lens,
     with bounds and SDPA; `hunyuan_run`, `python -m finetrainers_tpu_torch.train`
     with the modal_labs_dissolve train.sh's flags (one card, `ops_attn` for
     the example's `ops`, which does not fit, `transformer:ring`, rank 32) from
     2 videos written with cv2 at 49x480x768 (18,976 tokens): 3 steps, K1 62,
     the pre-pass 124, K2 62, K3 62 and the reduce pass 2 a step, the final
     validation from the exported adapter (1 request, 2 steps of 50: K1 and
     the pre-pass 124), whether the VAE ran in strips, step seconds, model
     TFLOP/s, peaks, precompute seconds per video and a profiled step;
     `hunyuan_serve`, one 49x480x768 request through `inference.main` with
     `--attn_provider flash`, the runner's guidance 5.0, 3 Euler steps of 50
     with shift 7 from a scheduler config, and that adapter: a finite (49,
     480, 768, 3) video written as .mp4, every LoRA factor of the served model
     the adapter's, K1 and the pre-pass 62 times a step and no other kernel,
     request, step and decode seconds, whether the decode ran in strips, the
     peak and a profiled step;
  15. CogView4-6B at full width with the control trainer
     (`COGVIEW4_TRANSFORMER_CONFIG` widened to 32 input channels, LoRA rank
     128: 6,631,406,656 parameters, 264,769,536 trained, bf16):
     `cogview4_kernel_checks`, K1 and the pre-pass at the joint
     self-attention (1, 32, 5120, 5120, 128; 1024 text slots with identity
     rows and 64x64 patches' 2D RoPE) and at the CFG batch (2, ...), and the
     pre-pass, K2 and K3 at the training shape, head by head against their
     plain versions, with bounds and SDPA; `cogview4_control_run`, `python -m
     finetrainers_tpu_torch.train` with the canny train.sh's flags (one card,
     `ops`, `transformer:auto`, `--control_type canny`) from 4 photos written
     with cv2 at 1024x1024: 4 steps, K1 28, the pre-pass 56, K2 28 and K3 28
     a step and no reduce pass, the final validation with a control image
     from the exports in a fresh widened model (2 steps, CFG: K1 and the
     pre-pass 56), the adapter and `control_aux_weights.safetensors`
     reloaded bit-equal, step seconds, model TFLOP/s, peaks and a profiled
     step; `cogview4_serve`, a control-lora request with that adapter and a
     Canny map and a plain text-to-image request, each 1024x1024 through
     `inference.main` with `--attn_provider flash`, 4 Euler steps of 50, CFG
     5.0: finite (1024, 1024, 3) PNGs, K1 and the pre-pass 28 a step and no
     other kernel, request, step and decode seconds, peaks and a profiled
     step; `wan_control_run`, the Wan image_condition train.sh's flags
     (`--control_type none`, `index` 0, `transformer:ring`) from 2 videos
     with paired control videos at 49x480x832: 4 steps launching as
     `wan_run`'s, the final validation through the pipeline's control branch;
  16. CogVideoX-5B at full width (`COGVIDEOX_5B_CONFIG`: 42 blocks, 48 heads
     x 64; 5,569,760,832 parameters, 74,317,824 LoRA at rank 32, bf16):
     `cogvideox_kernel_checks`, K1 and the pre-pass at the joint
     self-attention (1, 48, 30466, 30466, 64; 226 T5 slots with identity rows
     and 21x30x48 patches' 3D RoPE; K1's last q block 130 rows, the last kv
     tile 2) and at the CFG batch (2, ...), and the pre-pass, K2 and K3 at the
     training shape, head by head against their plain versions, with bounds
     and SDPA; `cogvideox_run`, `python -m finetrainers_tpu_torch.train` with
     the crush_smol_lora train.sh's flags (one card, COGVIDEOX_RUN_POLICY for
     the example's `ops`, `transformer:auto`) from 2 videos written with cv2
     at 81x480x768, the transformer at full width cut to COGVIDEOX_RUN_BLOCKS
     (6) of its 42 blocks: 3 DDIM steps with weights 1 / (1 - alpha_bar[t]),
     K1 6, the pre-pass 12, K2 6 and K3 6 a step and no reduce pass, the
     final validation of the example's first prompt from the export in a
     fresh model (2 steps, CFG: K1 and the pre-pass 12), the adapter reloaded
     bit-equal, step seconds, model TFLOP/s, peaks and a profiled step;
     `cogvideox_serve`, one 81x480x768 request through `inference.main` with
     cogvideox_text_to_video.sh's flags and that adapter (6 blocks), 2 DDIM
     steps of 50, CFG 5.0: a finite (81, 480, 768, 3) video, K1 and the
     pre-pass 6 a step and no other kernel, request, step and decode
     seconds, the peak and a profiled step;
  17. head dim 32 and the dummy family (its own width: dim 64 in 2 heads of
     32, 2 blocks, 16 caption slots): `h32_kernel_checks`, every kernel at
     head dim 32 (K1, the pre-pass, K2 split, with its reduce pass, and
     unsplit, K3, K5 and its dq emit, K7a/b/c, the sage pre-pass's codes
     against the CPU's and K6) against its plain version at the dummy's
     self-attention (1, 2, 4352, 4352, 32) and cross-attention (16 keys,
     kv_lens), a ragged case with an empty row, per-head and shared tables
     and a long ragged case (1, 24, 16400, 16400, 32; kv_lens 16390), with
     bounds that count the exponentials, and SDPA; `dummy_run`, `python -m finetrainers_tpu_torch.train
     --model_name dummy` from 4 videos written with cv2 at 17x256x256 (4352
     tokens): a LoRA run (4 steps, K1 2, the pre-pass 4, K2 2 with 2 reduce
     passes and K3 2 a block and step, the final validation), the same LoRA
     run under `--attn_provider_training transformer:flash_varlen` (losses
     bit-equal to the default run's) and under each kernel switch (K5 and
     its emit, K7a, K7b or K7c in every step and validation as JAX's gates
     send the dummy's calls, exact; losses within 1e-3 of the default run's,
     K5's first bit-equal; no library attention kernel in a traced step), and
     a full-finetune run under `adamw-bnb-8bit` (int8 moments for the
     feed-forward kernels); `dummy_serve`, one request through `inference.main
     --model_name dummy` with the LoRA adapter (K1 and the pre-pass 2 a block
     and step), then the same under `--attn_provider sage` (the sage pre-pass
     and K6 2 a block and step, its video within 0.1 of the first's);
  18. CogView4-6B's raider_white_tarot SFT example: `cogview4_sft_run`, its
     train.sh's flags through `python -m finetrainers_tpu_torch.train` (LoRA
     rank 32, `ops`, `transformer:auto`, the frozen weights stored int8 and
     run on int8 GEMMs) from 4 photos written with cv2 at its own 1280x720
     bucket (4624 tokens): 4 steps and the final validation, launches, the int8
     GEMMs a step, step seconds, model TFLOP/s, peak memory, the bytes stored
     as int8, the int8- and float8_e4m3fn-stored steps' loss and LoRA gradient
     against a bf16-stored step's on one batch, the adapter reloaded
     bit-equal; `cogview4_sft_int8_linear_check`, int8_linear's forward and
     dx at the feed-forward's down projection (4624 x 16384 -> 4096) against
     an exact emulation of its quantization, integer products and dequant,
     with two known-wrong controls that must fail; `cogview4_sft_serve`, one 1024x1024 request through
     `inference.main --quantize_int8` with that adapter: K1 and the pre-pass
     28 a step, one int8 GEMM per int8 layer and step, and a denoise step
     against the same step with the base weights in bf16;
  19. `k1_mask_check` (run with the kernel checks, after K7): K1's dense-mask
     branch against its plain version at the towers' shapes (GLM-4's 32 heads
     over 2 kv heads repeated, 1024 tokens, causal; Llama-3's 32 over 8, 351
     tokens, causal and padding; CLIP-L text's 77 tokens at head dim 64) and on
     block-sparse masks with an all-zero key tile, empty rows and ragged last
     tiles (skipped tiles' k and v rows filled with large values leave out
     bit-equal), times beside SDPA given the same mask; `k1_mask_long_causal`,
     (1, 32, 4096, 4096, 128) causal against unmasked K1; then
     `attention_branches`: the causal, segment and mask branches of K1, K2 and
     K3 through `attention_dispatch` and autograd in bf16 at the models'
     widths (BRANCH_CASES: `flash_varlen` over two of Wan 2.1's 480x832 clips
     packed to 20,352 tokens with their RoPE tables, each clip's rows against
     the clip run alone; `is_causal` at Llama-3-8B's (1, 32, 4096, 4096, 128)
     and (1, 32, 1024, 4096, 128), against K1's mask branch under the same
     causal mask; `flex` at CogView4-6B's (1, 32, 5120, 5120, 128) with the
     padded GLM slots' keys masked, whose dead key tiles filled with +-3e4
     leave every output bit-equal, and a block-sparse mask with an empty
     row), and the same three branches at head dim 32 at the dummy family's
     width (2 heads, 4352 tokens: two clips packed, causal, block-sparse):
     each against its plain version, launch counts exact with no
     library attention kernel, kernel and device times, bounds over the live
     pairs, SDPA given the same mask; at each case `variant_branches`, the
     branches of K7c, K7a and K7b (segments; K7b without tables) and K5 under
     the switches that reach them, through the dispatcher with exact launches
     and no library kernel, each against its plain version, K1's branch or
     K2+K3's, and the dead-tile fill; `attention_branches_switches`, every
     (switch, branch) pair at a small shape at head dims 128 and 32 against
     the plain versions with exact launches; `attention_branch_pairs`, K2's,
     K3's and K5's selects pair by pair at head dims 32, 64 and 128;
  20. `text_towers`: GLM-4-9B, Llama-3-8B and CLIP-L's text tower at their
     published configs, random on the card, one mask-branch launch a layer,
     each encode against the same tower under plain fp32 attention;
  21. `cogview4_checkpoint_serve`: a diffusers directory written here
     (transformer 2 of 28 blocks, the 2D AutoencoderKL, GLM-4 2 of 40 layers)
     loaded through the spec bit-equal, LoRA fresh, one 1024x1024 request of
     2 steps through the loaded GLM and VAE, then through the runner with a
     word-level tokenizer where `transformers` and `tokenizers` import, once
     under the default provider and once under `--attn_provider flex`, whose
     image must be bit-equal, and under `flex` with
     FINETRAINERS_FLASH_TWOLEVEL=1 (K7c's mask branch for the GLM, K7c for
     the transformer; the latents within TWOLEVEL_LATENT_REL_L2_TOL);
  22. `wan_checkpoint_run`, `ltx_checkpoint_serve`: Wan 2.1 and LTX-Video
     from local diffusers directories written here;
  23. `cogvideox_checkpoint_run`, `hunyuan_checkpoint_run`,
     `flux_checkpoint_run`: CogVideoX-5B (4 of 42 blocks at full width, in 3
     shards), HunyuanVideo and FLUX.1-dev (2 dual and 2 single blocks)
     from local diffusers directories written here with their faithful VAEs
     and towers: each example's train.sh through `train.main` for 2 steps,
     base weights bit-equal to the files, LoRA factors fresh, launches exact;
     CogVideoX then serves a CFG request through the runner with the adapter,
     HunyuanVideo decodes 49x480x768 untiled and its runner refuses (ROADMAP.md
     section 3 finding 14), Flux decodes 1280x720; `video_dtype_check`, the
     towers and the four faithful VAEs in bf16 against fp32;
  24. `env`: whether `cv2`, `PIL`, `transformers` and `tokenizers` import on this
     machine (information only).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is not
0. Without a CUDA card it raises before printing any result.
"""

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.constants import PRECOMPUTED_DIR_NAME
from finetrainers_tpu_torch.data import to_device
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.ltx_video.transformer import LTXRotaryPosEmbed
from finetrainers_tpu_torch.models.flux import FLUX_TRANSFORMER_CONFIG
from finetrainers_tpu_torch.models.wan import WAN_I2V_14B_CONFIG
from finetrainers_tpu_torch.models.wan.transformer import WanRotaryPosEmbed
from finetrainers_tpu_torch.ops import _build, attention_dispatch, attention_provider, flash_attention
from finetrainers_tpu_torch.ops import attention as attention_ops
from finetrainers_tpu_torch.ops.flash_attention import (
    _rope_bwd,
    _variant_branch,
    dkdv_splits,
    flash_attention_reference,
    flash_backward,
    flash_backward_fused_reference,
    flash_backward_reference,
    flash_bwd_dkdv,
    flash_bwd_dkdv_reference,
    flash_bwd_dq,
    flash_bwd_dq_emit,
    flash_bwd_dq_reference,
    flash_bwd_fused,
    flash_forward,
    flash_forward_core,
    flash_forward_core_reference,
    flash_forward_masked_core,
    mask_tiles,
    flash_forward_skew,
    flash_forward_skew_reference,
    flash_forward_two_level,
    flash_forward_two_level_reference,
    flash_forward_twopass,
    flash_forward_twopass_reference,
    flash_qk_prep,
    flash_qk_prep_reference,
    live_pairs,
)
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, apply_lora_state_dict, load_lora_weights
from finetrainers_tpu_torch.ops.sage_attention import sage_attention_reference, sage_forward, sage_prep, sage_quantize
from finetrainers_tpu_torch.trainer import SFTTrainer

NUM_STEPS = 4  # cut from the pipeline's default 50 (and from 8) to keep the run short
NUM_LAYERS = 28
BASE_PARAMS = 1_923_385_472  # the published LTX-Video transformer (jax.eval_shape on the JAX model)
PROMPTS = ("a red fox runs through fresh snow at dawn", "waves break on a rocky shore under a grey sky")
REQUEST = dict(num_frames=49, height=512, width=768, guidance_scale=3.0, num_inference_steps=NUM_STEPS)
# K1 (bf16 output) against the fp32 reference: |out - ref| <= K1_TOL * max(1, |ref|) elementwise,
# i.e. about two units in the last place of a bf16 value.
K1_TOL = 2e-2
LSE_TOL = 1e-2
# At Wan's 19968 keys a typical output value is ~1e-2, so the elementwise limit above is as large as
# the values: K1's Wan check also holds the relative L2 against the plain version to this limit.
K1_REL_L2_TOL = 1e-2
# K2/K3 (bf16 gradients) against the reference on the same bf16 inputs: the kernels' exp2 and fp32
# sums round a p or a ds to the neighbouring bf16 value now and then.
BWD_REL_L2_TOL = 1e-2
BWD_MAX_RATIO_TOL = 2e-2
STEP_REL_L2_TOL = 5e-2
TRAIN_LOSS_REL_TOL = 1e-2
# Training: LoRA rank and alpha as bench.py trains, B=1, the VAE moments of a 49x512x768 clip at
# the LTX VAE's 32x spatial / 8x temporal compression, 128 caption tokens of which 37 are valid.
TRAIN_RANK = 128
TRAIN_TIMED_STEPS = 3
MOMENTS_SHAPE = (1, 256, 7, 16, 24)
CAPTION_LEN, CAPTION_VALID = 128, 37
# Wan 2.1 T2V-1.3B serving: the repo's own Wan shape (tools/wan_attn_bench.py), 49x512x768 ->
# 13x64x96 latents -> 13x32x48 = 19968 tokens after the (1, 2, 2) patch; text padded to 512 tokens.
WAN_STEPS = 2  # cut from the pipeline's default 50 (and from 4) to keep the run short
WAN_LAYERS = 30
WAN_PARAMS = 1_418_996_800  # WAN_T2V_1_3B_CONFIG (jax.eval_shape on the JAX model)
WAN_REQUEST = dict(num_frames=49, height=512, width=768, guidance_scale=5.0, num_inference_steps=WAN_STEPS)
WAN_GRID = (13, 32, 48)
WAN_TOKENS = 19968
# The Wan example's own bucket (examples/training/sft/wan/crush_smol_lora/training.json): 49x480x832 ->
# 13x60x104 latents -> 13x30x52 = 20280 tokens, 158 full 128-row tiles and a ragged one of 56 rows.
WAN_RUN_BUCKET = (49, 480, 832)
WAN_RUN_GRID = (13, 30, 52)
WAN_RUN_TOKENS = 20280
# K6 (bf16 output) against its plain version on the same codes: |out - ref| <= K6_TOL * max(1, |ref|)
# elementwise and relative L2 <= K6_REL_L2_TOL (the kernel rounds p to bf16 before P V).
K6_TOL = 2e-2
K6_REL_L2_TOL = 1e-2
# A denoise step with K6 against the same step with K1: int8 q/k against bf16, through 30 blocks.
K6_STEP_REL_L2_TOL = 0.1
# Wan 2.1 I2V-14B (WAN_I2V_14B_CONFIG, JAX models/wan/base_specification.py:35-39): 40 blocks, 40 heads x 128,
# ffn 13824, in_channels 36 (16 noisy + 4 mask + 16 condition latents), image_dim 1280; 16,419,458,624
# parameters and 179,568,640 more at LoRA rank 32 (jax.eval_shape on the JAX model). Serving at the pipeline's
# default 81x480x832 (21x60x104 latents -> 32760 tokens, 255 full 128-row tiles and one of 120; the image
# branch attends to 257 CLIP tokens, 2 full tiles and one key); training at the example's 49x480x832 bucket.
I2V_PARAMS = 16_419_458_624
I2V_LORA_PARAMS = 179_568_640
I2V_LAYERS = 40
I2V_HEADS = 40
I2V_SERVE_GRID = (21, 30, 52)
I2V_SERVE_TOKENS = 32760
I2V_IMAGE_TOKENS = 257
I2V_STEPS = 2  # cut from the pipeline's default 50
I2V_REQUEST = dict(num_frames=81, height=480, width=832, guidance_scale=5.0, num_inference_steps=I2V_STEPS)
I2V_TRAIN_MOMENTS = (1, 32, 13, 60, 104)
# One timed step after the warm-up; the profiled step is the third: the warm-up's rate is 0 (the example's warmup
# schedule) and lora_B starts at 0, so lora_A first moves on the third step, and the check that every factor moved
# follows it.
I2V_TRAIN_TIMED_STEPS = 1
# The scheduler config of the public Wan-AI/Wan2.1-I2V-14B-480P-Diffusers checkpoint, the keys JAX
# `load_scheduler` reads (and the rest of its sampler settings).
I2V_SCHEDULER_CONFIG = {"_class_name": "UniPCMultistepScheduler", "num_train_timesteps": 1000, "flow_shift": 3.0,
                        "solver_order": 2, "solver_type": "bh2", "lower_order_final": True, "disable_corrector": [],
                        "prediction_type": "flow_prediction", "use_flow_sigmas": True}
# FLUX.1-dev (FLUX_TRANSFORMER_CONFIG, JAX models/flux/base_specification.py:34-38): 19 dual and 38 single blocks,
# 24 heads x 128, joint dim 4096, pooled 768, guidance embeds; 11,901,408,320 parameters (jax.eval_shape on the JAX
# model). Each block runs one joint attention over [512 text, image] tokens with per-token RoPE tables whose text
# rows are the identity. Serving at 1024x1024: 128x128 latents -> 64x64 = 4096 image tokens, 4608 in all (36 full
# 128-row tiles). Training at the flux_dev example's own 1280x720 bucket (height x width,
# examples/training/sft/flux_dev/raider_white_tarot/training.json): 160x90 latents -> 80x45 = 3600 image tokens,
# 4112 in all (32 full tiles and one of 16 rows).
FLUX_PARAMS = 11_901_408_320
FLUX_LAYERS = 57  # 19 dual + 38 single, one attention each
FLUX_HEADS = 24
FLUX_TEXT = 512
FLUX_AXES = (16, 56, 56)
FLUX_SERVE_LATENT = (128, 128)
FLUX_SERVE_TOKENS = 4608
FLUX_RUN_BUCKET = (1280, 720)
FLUX_RUN_LATENT = (160, 90)
FLUX_RUN_TOKENS = 4112
FLUX_SERVE_STEPS = 2  # cut from the pipeline's default 28 (and from 4)
FLUX_EXAMPLE = (pathlib.Path(__file__).resolve().parent / "examples" / "training" / "sft" / "flux_dev"
                / "raider_white_tarot")
FLUX_RUN_IMAGES, FLUX_RUN_STEPS = 4, 4  # cut from the example's 50 precomputed items and 1000 steps
FLUX_RANK = 32
# The scheduler config of the public black-forest-labs/FLUX.1-dev checkpoint.
FLUX_SCHEDULER_CONFIG = {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000, "shift": 3.0,
                         "use_dynamic_shifting": True, "base_shift": 0.5, "max_shift": 1.15,
                         "base_image_seq_len": 256, "max_image_seq_len": 4096}
# HunyuanVideo (HUNYUAN_VIDEO_CONFIG, JAX models/hunyuan_video/base_specification.py:28-32): 20 dual and 40 single
# blocks (Flux's), 2 token-refiner blocks, 24 heads x 128, text 4096, pooled 768, guidance embeds;
# 12,817,866,816 parameters and 141,164,544 more at LoRA rank 32 (jax.eval_shape on the JAX model). Each of the 60
# blocks runs one joint attention over [256 text, video] tokens with per-token RoPE tables over (frame, row, col)
# ids, identity rows for the text; each refiner block a self-attention over the 256 text slots with kv_lens and no
# tables. The modal_labs_dissolve example's bucket (and the serving example's size) 49x480x768: 13x60x96 latents ->
# 13x30x48 = 18,720 video tokens, 18,976 in all (148 full 128-row tiles and one of 32 rows).
HUNYUAN_PARAMS = 12_817_866_816
HUNYUAN_LORA_PARAMS = 141_164_544
HUNYUAN_LAYERS = 60  # 20 dual + 40 single, one joint attention each
HUNYUAN_REFINER_LAYERS = 2
HUNYUAN_HEADS = 24
HUNYUAN_TEXT = 256
HUNYUAN_AXES = (16, 56, 56)
HUNYUAN_BUCKET = (49, 480, 768)
HUNYUAN_RUN_GRID = (13, 30, 48)
HUNYUAN_TOKENS = 18976
# The offline hash encoder fills the 256 slots with the Llama template's 58 words and the caption's: 65 valid is
# the refiner's shape in the kernel checks, so its second kv tile (keys 128-255) holds no valid key.
HUNYUAN_REFINER_VALID = 65
HUNYUAN_EXAMPLE = (pathlib.Path(__file__).resolve().parent / "examples" / "training" / "sft" / "hunyuan_video"
                   / "modal_labs_dissolve")
HUNYUAN_RUN_VIDEOS, HUNYUAN_RUN_STEPS = 2, 3  # cut from the example's 50 precomputed items and 3000 steps
HUNYUAN_RANK = 32
# The example trains under "ops", which keeps every product of the 60 blocks: at 18,976 tokens it, and "ops_narrow"
# too, runs out of the card's 80 GB (`python3 tools/torch_hunyuan_phases.py OUT.jsonl policies`). The run uses
# "ops_attn".
HUNYUAN_RUN_POLICY = "ops_attn"
HUNYUAN_SERVE_STEPS = 2  # cut from the request's 50 (and from 3)
# The scheduler config of the public hunyuanvideo-community/HunyuanVideo checkpoint.
HUNYUAN_SCHEDULER_CONFIG = {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000,
                            "shift": 7.0}
# CogView4-6B at full width with the control trainer (the canny control-LoRA example): the transformer widened
# to 32 input channels (2x the 16 latent channels) with LoRA rank 128 (jax.eval_shape on the JAX model), one
# joint self-attention a block over 1024 GLM slots (the offline encoder's states padded to 1024) and 64x64 image
# patches of a 1024x1024 image.
COGVIEW4_EXAMPLE = (pathlib.Path(__file__).resolve().parent / "examples" / "training" / "control" / "cogview4"
                    / "canny")
COGVIEW4_PARAMS = 6_631_406_656
COGVIEW4_TRAINED = 264_769_536  # the LoRA factors (264,241,152) and the injection layer `patch_embed.proj`
COGVIEW4_LAYERS = 28
COGVIEW4_HEADS = 32
COGVIEW4_TEXT = 1024
COGVIEW4_BUCKET = (1024, 1024)
COGVIEW4_GRID = (64, 64)
COGVIEW4_TOKENS = 5120
COGVIEW4_RANK = 128
COGVIEW4_RUN_IMAGES, COGVIEW4_RUN_STEPS = 4, 4  # cut from 50 precomputed items and 10000 steps
COGVIEW4_SERVE_STEPS = 4  # cut from the request's 50
# CogVideoX-5B (COGVIDEOX_5B_CONFIG, JAX models/cogvideox/base_specification.py:28-32): 42 blocks of 48 heads x 64,
# width 3072; 5,569,760,832 parameters and 74,317,824 more at the crush_smol example's LoRA rank 32 (jax.eval_shape
# on the JAX model). Each block runs one joint attention over [226 T5 slots, video] with per-token 3D RoPE tables
# (identity rows for the text). The example's bucket (and the serving example's size) 81x480x768: 21x60x96 latents
# -> 21x30x48 = 30,240 video tokens, 30,466 in all: 238 full 128-row tiles and one of 2 rows, and for K1 at H=64
# (three consumer warpgroups, 192-row q blocks) 158 full q blocks and one of 130 rows.
COGVIDEOX_EXAMPLE = (pathlib.Path(__file__).resolve().parent / "examples" / "training" / "sft" / "cogvideox"
                     / "crush_smol_lora")
COGVIDEOX_SERVE_EXAMPLE = pathlib.Path(__file__).resolve().parent / "examples" / "inference" / "cogvideox"
COGVIDEOX_PARAMS = 5_569_760_832
COGVIDEOX_LORA_PARAMS = 74_317_824
COGVIDEOX_LAYERS = 42
# The crush_smol_lora run and its request run at full width cut to 6 of the 42 blocks (once trained and served at
# the whole depth): the script's time limit.
COGVIDEOX_RUN_BLOCKS = 6
COGVIDEOX_HEADS = 48
COGVIDEOX_TEXT = 226
COGVIDEOX_BUCKET = (81, 480, 768)
COGVIDEOX_GRID = (21, 30, 48)
COGVIDEOX_TOKENS = 30466
COGVIDEOX_RUN_VIDEOS, COGVIDEOX_RUN_STEPS = 2, 3  # cut from the example's 50 precomputed items and 3000 steps
COGVIDEOX_RANK = 32
# The example trains under "ops", which keeps every product of the 42 blocks: at 30,466 tokens it, and "ops_narrow"
# too, runs out of the card's 80 GB (`python3 tools/torch_cogvideox_phases.py OUT.jsonl policies`). The run uses
# "ops_attn", the first policy that saves less and fits (34.8 GB).
COGVIDEOX_RUN_POLICY = "ops_attn"
COGVIDEOX_SERVE_STEPS = 2  # cut from the request's 50
# The Wan image_condition control example: Wan 2.1 T2V-1.3B widened to 32 input channels, LoRA rank 128.
# The dummy family: its own full width, dim 64 in 2 heads of 32, 2 blocks, 16 caption slots; the run's
# 17x256x256 videos give 17 x 16 x 16 = 4352 tokens after the 8x VAE and the (1, 2, 2) patches.
DUMMY_HEADS, DUMMY_LAYERS, DUMMY_CAPTION = 2, 2, 16
DUMMY_BUCKET = (17, 256, 256)
DUMMY_TOKENS = 4352
DUMMY_RANK = 16
DUMMY_RUN_VIDEOS, DUMMY_RUN_STEPS, DUMMY_FULL_STEPS = 4, 4, 3
DUMMY_SERVE_STEPS = 4
# CogView4-6B's raider_white_tarot SFT example (examples/training/sft/cogview4/raider_white_tarot/train.sh): LoRA rank
# 32 under "ops" with the transformer's frozen weights stored int8; its own 1280x720 bucket: 80 x 45 = 3600 patches
# beside the 1024 GLM slots, 4624 tokens (36 full 128-row tiles and a 16-row one).
RAIDER_EXAMPLE = pathlib.Path(__file__).resolve().parent / "examples" / "training" / "sft" / "cogview4" / "raider_white_tarot"
RAIDER_BUCKET = (1280, 720)
RAIDER_TOKENS = 4624
RAIDER_RANK = 32
RAIDER_RUN_IMAGES, RAIDER_RUN_STEPS = 4, 4  # cut from 50 precomputed items and 5000 steps
RAIDER_SERVE_STEPS = 2  # cut from the request's 50 (and from 4)
# Bounds of a step under weight storage against the bf16-stored step on the same batch, draws and LoRA factors: each
# int8 layer's output carries ~1.5% relative rms error (weights per output channel and activations per row quantized
# to 127 levels of their absmax: ~0.9% and ~1% rms), e4m3fn's ~2.5% (3 mantissa bits, no activation quantization), and
# the errors of 28 blocks add in quadrature; the loss, a mean of squares, moves by the square of the relative error
# and its cross term averages out; the LoRA gradients are products of perturbed activations and perturbed
# backpropagated errors. int8's input gradient also quantizes each row of the cotangent dy * s_w to 127 levels of
# its absmax in every frozen layer (JAX's int8_linear, ops/int8_linear.py:74-90), heavy-tailed rows whose small
# entries round to 0: its LoRA gradients carry ~2x e4m3fn's error (PERF.md: 0.45-0.47 against 0.24 at the run's
# factors; at random factors 0.24, and 0.067 with the cotangent left unquantized, `tools/torch_dummy_phases.py
# diagnose`).
STORAGE_LOSS_REL_TOL = {"int8": 1e-2, "float8_e4m3fn": 2e-2}
STORAGE_GRAD_REL_L2_TOL = {"int8": 0.6, "float8_e4m3fn": 0.35}
# A denoise step served with --quantize_int8 against the same step with the base weights in bf16: ~1.5% relative error
# in each of the 198 int8 layers (7 a block over 28 blocks, and the time embedding's 2), in quadrature at most
# sqrt(198) x 1.5% ~ 0.2 (the residual stream carries part of each block's input past its errors).
QUANTIZED_STEP_REL_L2_TOL = 0.2
# The int8 gradient bound (0.6) and the serving bound (0.2) sit above the card's first readings (0.469 and 0.111)
# and hold the int8 path only against another precision: they are sanity bounds. The tight check of the int8
# products is `check_int8_linear`'s.
# int8_linear at one frozen layer of the raider run against a plain emulation of the same quantize -> integer
# product -> dequant: the codes and the integer products are exact, so only the epilogue's bf16 roundings remain,
# each within a relative 2^-8: five in the forward (the int32 sum, s_x, the product, s_w, the product) and three in
# dx (the sum, s_dy, the product), elementwise against the exact dequantized value.
INT8_FWD_REL_TOL = (1 + 2.0**-8) ** 5 - 1
INT8_DX_REL_TOL = (1 + 2.0**-8) ** 3 - 1
# The long head-dim-32 case: 16400 = 128 * 128 + 16 rows, the last 16-row tile ragged under kv_lens.
H32_LONG, H32_LONG_VALID = 16400, 16390
WAN_CONTROL_EXAMPLE = (pathlib.Path(__file__).resolve().parent / "examples" / "training" / "control" / "wan"
                       / "image_condition")
WAN_CONTROL_PARAMS = 1_594_076_224
WAN_CONTROL_TRAINED = 175_179_264  # the LoRA factors (174,981,120) and the injection layer `patch_embedding`
# Wan 2.1 T2V-1.3B LoRA training (tools/floor_bench.py's setup_wan with the optimizer of
# examples/training/sft/wan/crush_smol_lora/train.sh): rank 32, B=1, the VAE moments of a 49x512x768 clip
# (13x64x96 latents -> 19968 tokens), 512 caption tokens, all valid; per-block "full" remat.
WAN_TRAIN_RANK = 32
WAN_TRAIN_TIMED_STEPS = 2
# The timed steps of the same Wan step under each kernel switch and each remat policy: fewer than the default
# path's, to keep the script's run within half its limit as its paths grow.
WAN_SWITCH_TIMED_STEPS = 1
WAN_MOMENTS = (1, 32, 13, 64, 96)
WAN_SMALL_MOMENTS = (1, 32, 13, 32, 48)  # 4992 tokens: plain fp32 attention's scores fit under remat
WAN_CAPTION_LEN = 512
WAN_TRAIN_ARGS = dict(training_type="lora", rank=WAN_TRAIN_RANK, lora_alpha=WAN_TRAIN_RANK, seed=0, train_steps=3000,
                      flow_weighting_scheme="logit_normal", gradient_checkpointing=True,
                      gradient_checkpointing_type="full", optimizer="adamw", lr=5e-5,
                      lr_scheduler="constant_with_warmup", lr_warmup_steps=300, beta1=0.9, beta2=0.99,
                      weight_decay=1e-4, epsilon=1e-8, max_grad_norm=1.0)
# A step under a forward switch (K7a/b/c) against the step with K1: the same quantities with the softmax
# arithmetic reordered in fp32. Under the fused-backward switch (K5) the forward is K1's, so the loss is
# bit-equal; the LoRA gradient differs by K5's atomic fp32 sums of dq.
VARIANT_LOSS_REL_TOL = 1e-3
VARIANT_GRAD_REL_L2_TOL = 2e-2
FUSED_GRAD_REL_L2_TOL = 1e-2
# The remat policies of the Wan step (examples/training/sft/wan/crush_smol_lora/train.sh trains under "ops"). A
# selective policy saves K4's outputs and products that "full" recomputes with the same kernels on the same
# inputs: the loss must be bit-equal to "full"'s and the LoRA gradient within REMAT_GRAD_REL_L2_TOL.
REMAT_POLICIES = ("full", "ops", "ops_attn", "ops_narrow")
REMAT_GRAD_REL_L2_TOL = 2e-2
# Gradient accumulation, checkpoints and resume as the example configures them, cut to 6 micro-steps with
# a checkpoint every 2 and a forced one after 3, in the middle of an accumulation.
ACCUM_ARGS = dict(gradient_checkpointing_type="ops", gradient_accumulation_steps=2, checkpointing_steps=2,
                  checkpointing_limit=2)
ACCUM_MICRO_STEPS, ACCUM_BROKEN_AT = 6, 3
# The training phases' checkpoints and exports, in the gitignored build/, removed when the run ends.
SMOKE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
# The Wan training paths besides the default one, each driven with the counts zeroed just before it.
WAN_PATH_KEYS = ("k7a", "k7b", "k7c", "fused_bwd", "ops", "ops_attn", "ops_narrow", "accum")
SWITCHES = ("FINETRAINERS_FLASH_FUSED_BWD", "FINETRAINERS_FLASH_TWOPASS", "FINETRAINERS_FLASH_SKEW",
            "FINETRAINERS_FLASH_TWOLEVEL")
# The kernels whose ptxas record must show no spill: the eight wgmma kernels K1, K2, K3, K5, K6 and K7a-c
# (their consumers run at 240 and 160 registers).
NO_SPILL_KERNELS = ("flash_fwd_sm90_kernel", "bwd_dkdv_sm90_kernel", "bwd_dq_sm90_kernel", "sage_fwd_sm90_kernel",
                    "bwd_fused_sm90_kernel", "flash_fwd_twopass_sm90_kernel", "flash_fwd_two_level_sm90_kernel",
                    "flash_fwd_skew_sm90_kernel", "flash_fwd_mask_sm90_kernel", "flash_fwd_causal_sm90_kernel",
                    "flash_fwd_segment_sm90_kernel", "flash_fwd_two_level_causal_sm90_kernel",
                    "flash_fwd_two_level_segment_sm90_kernel", "flash_fwd_two_level_mask_sm90_kernel",
                    "flash_fwd_twopass_segment_sm90_kernel", "flash_fwd_skew_segment_sm90_kernel")
# H100 SXM dense peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# The SFU's exp2 rate: 16 per SM per clock on 132 SMs at the 1.83 GHz boost clock that PEAK_BF16_FLOPS implies
# (989e12 / (132 * 4096 flops a clock)), ~3.87e12/s. At head dim 32 a score costs 128 tensor flops but one
# exponential, so the exponentials bound K1, K2 and K3 before the tensor cores do; at head dim 64 the two are equal.
PEAK_EXP2_PER_S = 132 * 16 * 1.83e9


_T0 = time.perf_counter()


def phase(name, **fields):
    """Print one phase line, with the seconds since the script started (`t_s`)."""
    print(json.dumps({"phase": name, **fields, "t_s": time.perf_counter() - _T0}), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Median over `iters` launches of the CUDA-event time of one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_call(fn):
    """One call of `fn`, timed with CUDA events: (its result, ms). A plain
    version that is also the reference of a check is timed on the call the
    check needs, as `cuda_ms(fn, iters=1, warmup=0)` would time a second one."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# Small kernels launched before the timed calls inside each `device_ms` trace: torch.profiler now and then misses
# the first few kernel records of a trace (`tools/torch_device_ms_probe.py`), and these are the ones it misses.
DEVICE_MS_PAD = 32


def device_ms(fn, kernels, calls=5, tries=3):
    """Device time of one call of `fn` from torch.profiler: over `calls` calls
    (after one warm-up), the median duration of each kernel whose name
    contains one of `kernels`, summed over them (a median, as one whole-script
    trace held a record far below the kernel's bound). DEVICE_MS_PAD small
    kernels precede the calls inside the trace, so that records missed at its
    start are theirs. A trace counts only where it holds exactly `calls`
    launches of every kernel named (each must launch once per call); else
    another is taken, and None comes back after `tries` traces that fall
    short. Unlike `cuda_ms` it leaves out the host's time to issue them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(DEVICE_MS_PAD):
                pad.add_(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA
                  and not getattr(evt, "is_user_annotation", False)]
        by_kernel = [[evt.time_range.elapsed_us() for evt in events if k in evt.name] for k in kernels]
        if all(len(us) == calls for us in by_kernel):
            return sum(statistics.median(us) for us in by_kernel) / 1e3
    return None


def bound(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rel_errors(got, ref):
    """(relative L2 error, max |error| / max |ref|, max |error|)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return ((got - ref).norm() / ref.norm()).item(), (err.max() / ref.abs().max()).item(), err.max().item()


def ltx_train_step_flops(cfg: dict, lora_rank: int, remat_factor: float, B: int, S: int, L_CTX: int) -> float:
    """Analytic matmul FLOPs for one LoRA train step on the LTX transformer
    (copied from bench.py's `ltx_train_step_flops`, with its shape constants as
    arguments). fwd counted exactly (matmul terms only); bwd for LoRA training
    needs dL/dx through every base matmul (~1x fwd) plus LoRA factor grads;
    remat recomputes `remat_factor` of the fwd."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    nl = cfg["num_layers"]
    cap = cfg["caption_channels"]
    cin = cfg["in_channels"]

    per_layer = 0.0
    per_layer += 4 * 2 * S * d * d            # attn1 q,k,v,out projections
    per_layer += 2 * 2 * S * S * d            # attn1 scores + weighted sum
    per_layer += 2 * 2 * S * d * d            # attn2 q,out
    per_layer += 2 * 2 * L_CTX * d * d        # attn2 k,v
    per_layer += 2 * 2 * S * L_CTX * d        # attn2 scores + out
    per_layer += 2 * 2 * S * d * 4 * d        # ff in + out
    per_layer += 6 * 2 * S * (d * lora_rank + lora_rank * d)

    fwd = nl * per_layer
    fwd += B * S * 2 * (256 * d + d * d + d * 6 * d)
    fwd += B * L_CTX * 2 * (cap * d + d * d)
    fwd += B * S * 2 * (cin * d + d * cin)

    fwd *= B
    return fwd * (2.0 + remat_factor)


# Kernel names of K2 (with its reduce pass) and K3, for `device_ms`.
K2_KERNELS = ("bwd_dkdv_sm90_kernel", "dkdv_reduce_kernel")
K3_KERNELS = ("bwd_dq_sm90_kernel",)


def k2_kernels(q_s, k_r):
    """K2's names for `device_ms` on BNSH operands q_s, k_r: the reduce pass's
    too where `dkdv_splits` cuts the q loop, else K2's alone."""
    b, n, sq, _ = q_s.shape
    splits = dkdv_splits(b, n, sq, k_r.shape[2], torch.cuda.get_device_properties(0).multi_processor_count)[0]
    return K2_KERNELS if splits > 1 else K2_KERNELS[:1]


# Profile classes by kernel name; the pre-pass's class counts its forward and backward launches.
_KERNEL_CLASSES = (("k1", "flash_fwd_sm90_kernel"), ("k2", K2_KERNELS[0]), ("k2_reduce", K2_KERNELS[1]),
                   ("k3", K3_KERNELS[0]), ("prep", "rope_prep_kernel"), ("k6", "sage_fwd_sm90_kernel"),
                   ("sage_prep", "sage_prep_quant_kernel"), ("sage_prep_sum", "sage_prep_sum_kernel"),
                   ("sage_prep_mean", "sage_prep_mean_kernel"))
# The sage pre-pass's three kernels, one launch of `sage_prep` each.
SAGE_PREP_KERNELS = ("sage_prep_quant_kernel", "sage_prep_sum_kernel", "sage_prep_mean_kernel")


@contextlib.contextmanager
def counted(module, name):
    """Count the calls of `module.name` for the duration, in the yielded one-item list."""
    fn, calls = getattr(module, name), [0]

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def profile_device(fn):
    """Device time of one call of `fn` by class from torch.profiler: the port's
    kernels (each launch kept in launch order), cuBLAS GEMMs, everything else.
    Only the card's activity is traced: tracing the host's ops as well slows
    their issue, which inflates the idle share of a host-bound step, and
    parsing their events takes seconds at full width
    (`tools/torch_profiler_probe.py`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    classes, kernels, launches = {"gemm": 0.0, "other": 0.0}, {}, {cls: [] for cls, _ in _KERNEL_CLASSES}
    events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
    for evt in events:
        if getattr(evt, "is_user_annotation", False):  # e.g. "Optimizer.step#AdamW.step", spanning other kernels
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        name = evt.name.lower()
        kernels[evt.name[:90]] = kernels.get(evt.name[:90], 0.0) + ms
        cls = next((c for c, pattern in _KERNEL_CLASSES if pattern in name), None)
        if cls is not None:
            launches[cls].append((evt.time_range.start, ms))
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
            classes["gemm"] += ms
        else:
            classes["other"] += ms
    launches = {cls: [ms for _, ms in sorted(v)] for cls, v in launches.items()}
    busy = sum(classes.values()) + sum(sum(v) for v in launches.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    library = sorted(name for name in kernels if any(t in name.lower() for t in LIBRARY_ATTENTION))
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms if busy else None,
                classes=classes, launches=launches, top_kernels_ms=top, device_events=len(kernels),
                library_attention=library)


def _split(ms_list, by_order):
    """Self- and cross-attention launches of one kernel: by launch order (each
    block runs self, then cross) or, where the order is autograd's, by size
    (self-attention over 2688 keys costs ~20x cross-attention over 128)."""
    if by_order:
        return ms_list[0::2], ms_list[1::2]
    ranked = sorted(ms_list, reverse=True)
    return ranked[:len(ranked) // 2], ranked[len(ranked) // 2:]


def _median(xs):
    return statistics.median(xs) if xs else None


def forward_classes(prof):
    """A forward step's device ms by class, with K1 and the pre-pass split into
    self- and cross-attention (every block runs self, then cross), and their
    launch counts and median ms per launch."""
    classes, per_launch = dict(prof["classes"]), {}
    for cls in ("k1", "prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=True)
        classes[f"{cls}_self_attention"], classes[f"{cls}_cross_attention"] = sum(self_ms), sum(cross_ms)
        per_launch[cls] = {"launches": [len(self_ms), len(cross_ms)], "self_attention": _median(self_ms),
                           "cross_attention": _median(cross_ms)}
    return classes, per_launch


def ltx_tables(n, h):
    rope = LTXRotaryPosEmbed(n * h)
    cos, sin = rope.numpy_tables(7, 16, 24, (8 / 25, 32.0, 32.0))
    return tuple(torch.from_numpy(t).cuda().reshape(2688, n, h).transpose(0, 1).contiguous() for t in (cos, sin))


def exp_bound(record, exps):
    """The larger of `record` (ms, "operations" or "bytes") and `exps`
    exponentials at the SFU's rate (operations too)."""
    exp_ms = exps / PEAK_EXP2_PER_S * 1e3
    return (exp_ms, "operations") if exp_ms > record[0] else record


def k1_bound(b, n, sq, kv_eff, h):
    """K1's least time on the pre-pass's operands: its two products against q_s,
    k_r and v read once (the valid keys), out and the LSE written once; at
    H=32 also one exponential per score (`exp_bound`)."""
    record = bound(4 * n * sq * kv_eff * h, 2 * b * n * sq * h * 2 + 2 * n * kv_eff * h * 2 + b * n * sq * 4)
    return exp_bound(record, n * sq * kv_eff) if h == 32 else record


def bwd_bounds(b, n, sq, skv, kv_eff, h, cos):
    """K2's and K3's least times, (ms, "operations" or "bytes") each, on the
    pre-pass's operands: K2's four products against q_s, dO, LSE and delta
    read once, k_r and v of the valid keys read once, dk and dv written once
    and k's tables read; K3's three products against q_s, dO, LSE, delta and
    the valid keys read once, dq written once and q's tables read."""
    q_bytes, kv_eff_bytes, kv_bytes = b * n * sq * h * 2, n * kv_eff * h * 2, b * n * skv * h * 2
    row_bytes = b * n * sq * 4
    table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
    k2_bytes = 2 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + 2 * kv_bytes + table_bytes
    k2 = bound(8 * n * sq * kv_eff * h, k2_bytes)
    k3 = bound(6 * n * sq * kv_eff * h, 3 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + table_bytes)
    if h == 32:  # one exponential per score in each (p recomputed from the LSE)
        return exp_bound(k2, n * sq * kv_eff), exp_bound(k3, n * sq * kv_eff)
    return k2, k3


def k5_bound(b, n, sq, skv, kv_eff, h, cos):
    """K5's least time: five products against q_s, dO, LSE and delta read once, k_r and v of the valid
    keys read once, k's tables read, dk, dv and the fp32 dq accumulator written once."""
    q_bytes, kv_eff_bytes, kv_bytes = b * n * sq * h * 2, n * kv_eff * h * 2, b * n * skv * h * 2
    table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
    return bound(10 * n * sq * kv_eff * h, 4 * q_bytes + 2 * kv_eff_bytes + 2 * b * n * sq * 4 + 2 * kv_bytes
                 + table_bytes)


def qk_prep_bound(q, k, cos):
    """The pre-pass's least time: q read and q_s written, and with tables k read,
    k_r written and the tables read."""
    q_bytes, k_bytes = q.numel() * 2, k.numel() * 2
    return bound(0, 2 * q_bytes + (2 * k_bytes + 2 * cos.numel() * 4 if cos is not None else 0))


def dkdv_reduce_bound(b, n, sq, skv, h, sms):
    """K2's reduce pass's least time where `dkdv_splits` cuts the q loop over
    `splits` CTAs: the (2, splits, B, N, Skv, H) fp32 partials read once, dk and
    dv written once in bf16; no products (it also scales by ln2 and applies k's
    transpose rotation) -> ((ms, "bytes"), splits)."""
    splits, _ = dkdv_splits(b, n, sq, skv, sms)
    return bound(0, 2 * splits * b * n * skv * h * 4 + 2 * b * n * skv * h * 2), splits


def plain_dkdv_reduce(partials, lens, dtype):
    """The plain version of K2's reduce pass without tables: the (2, splits, B,
    N, Skv, H) fp32 partials summed over the splits, dk scaled by ln 2, both 0
    at keys at or past kv_lens[b], cast to `dtype`."""
    dk, dv = partials.sum(dim=1).unbind(0)
    dk = dk * float(np.log(2.0))
    if lens is not None:
        valid = (torch.arange(dk.shape[2], device=dk.device)[None, :] < lens[:, None])[:, None, :, None]
        dk, dv = torch.where(valid, dk, 0.0), torch.where(valid, dv, 0.0)
    return dk.to(dtype), dv.to(dtype)


def host_split(trainer, batch):
    """Where the host spends a step: issuing forward and backward, issuing the
    update, then waiting for the card. A wait near 0 means the host bounds the step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.optimizer.zero_grad()
    trainer.forward_backward(*batch)
    t1 = time.perf_counter()
    trainer.optimizer.step()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return dict(forward_backward_issue_s=t1 - t0, optimizer_issue_s=t2 - t1, wait_for_card_s=t3 - t2, step_s=t3 - t0)


def _fill_past_kv_lens(x, lens, value):
    """A copy of the BNSH `x` whose rows at or past lens[b] hold `value`."""
    y = x.clone()
    for bi, length in enumerate(lens):
        y[bi, :, length:] = value
    return y


def check_k1(card, cases=None, phase_name="k1_check"):
    """K1 against its plain version on the pre-pass's operands, and the pre-pass
    plus K1 (`flash_forward`) against `flash_attention_reference`, by default
    at the LTX serving path's shapes and Wan's cross-attention shapes
    (training B=1, serving B=2), and Wan I2V-14B's cross shapes (40 heads):
    training's text at 20280 tokens, and serving's at 32760 tokens, the text
    with kv_lens and the 257 image keys without. Wherever kv_lens < Skv the k/v
    rows past kv_lens are also filled with large values, which must leave out
    and LSE bit-equal (TMA reads those rows). Returns the worst error and the
    records by case."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cos_t, sin_t = ltx_tables(32, 64)
    cases = cases or {
        "self_rope": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope=(cos_t, sin_t)),
        "cross_kv_lens": dict(b=2, n=32, sq=2688, skv=128, h=64, lens=[1, 12], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[50, 0], rope=None),
        "wan_train_cross_kv_lens": dict(b=1, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "wan_serve_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512, 9], rope=None),
        "wan_run_cross_kv_lens": dict(b=1, n=12, sq=WAN_RUN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "i2v_train_cross_kv_lens": dict(b=1, n=I2V_HEADS, sq=WAN_RUN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "i2v_serve_cross_kv_lens": dict(b=2, n=I2V_HEADS, sq=I2V_SERVE_TOKENS, skv=512, h=128, lens=[512, 9],
                                        rope=None),
        "i2v_image_cross": dict(b=2, n=I2V_HEADS, sq=I2V_SERVE_TOKENS, skv=I2V_IMAGE_TOKENS, h=128, lens=None,
                                rope=None),
    }
    worst, records = 0.0, {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        # BTNH buffers viewed as BNSH, the layout the model hands the kernel.
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for s in (sq, skv, skv))
        lens = None if c["lens"] is None else torch.tensor(c["lens"], dtype=torch.int32, device="cuda")
        cs, sn = c["rope"] or (None, None)
        rope_sn = 0 if cs is None or cs.shape[0] == 1 else sq * h
        scale = h**-0.5
        out, lse = flash_forward(q, k, v, lens, cs, sn)
        q_s, k_r = flash_qk_prep(q, k, cs, sn, rope_sn, scale)
        core_out, core_lse = flash_forward_core(q_s, k_r, v, lens)
        torch.cuda.synchronize()
        # Past 4096^2 scores a head, the plain versions run one head at a time (all at once would not fit).
        by_head = sq * skv > 4096 * 4096

        def plain_core():
            if by_head:
                return _by_head(lambda *a: flash_forward_core_reference(*a, lens), n, (q_s, k_r, v), ())
            return flash_forward_core_reference(q_s, k_r, v, lens)

        def plain_full():
            if by_head:
                return _by_head(lambda q_, k_, v_, c_, s_: flash_attention_reference(q_, k_, v_, lens, c_, s_), n,
                                (q, k, v), (cs, sn))
            return flash_attention_reference(q, k, v, lens, cs, sn)

        core_ref, by_head_plain_ms = timed_call(plain_core)
        errs = {}
        for against, (got, got_lse), (ref, ref_lse) in (
                ("plain", (core_out, core_lse), core_ref), ("flash_attention_reference", (out, lse), plain_full())):
            err = (got.float() - ref.float()).abs()
            errs[against] = dict(max_abs_err=err.max().item(),
                                 err_over_max1_ref=(err / ref.float().abs().clamp_min(1.0)).max().item(),
                                 lse_max_abs_err=(got_lse - ref_lse).abs().max().item())
        empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
        past_lens_ok = None
        if c["lens"] is not None and any(length < skv for length in c["lens"]):
            big = flash_forward_core(q_s, _fill_past_kv_lens(k_r, c["lens"], 3e4), _fill_past_kv_lens(v, c["lens"], -3e4),
                                     lens)
            zeroed = flash_forward_core(q_s, _fill_past_kv_lens(k_r, c["lens"], 0.0), _fill_past_kv_lens(v, c["lens"], 0.0),
                                        lens)
            past_lens_ok = torch.equal(big[0], zeroed[0]) and torch.equal(big[1], zeroed[1])
        ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v, lens))
        prep_ms = cuda_ms(lambda: flash_qk_prep(q, k, cs, sn, rope_sn, scale))
        forward_ms = cuda_ms(lambda: flash_forward(q, k, v, lens, cs, sn))
        plain_ms = by_head_plain_ms if by_head else cuda_ms(plain_core, iters=5)
        del core_ref
        # The "native" provider (torch SDPA), a library baseline without the fused rotation, for comparison only.
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: attention_dispatch(qt, kt, vt, kv_lens=lens, provider="native"))
        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        bound_ms, bound_by = k1_bound(b, n, sq, kv_eff, h)
        phase(phase_name, case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], plain_by_head=by_head,
              vs_plain=errs["plain"],
              vs_flash_attention_reference=errs["flash_attention_reference"], empty_rows_zero=empty_zero,
              rows_past_kv_lens_ignored=past_lens_ok, ms=ms, prep_ms=prep_ms, flash_forward_ms=forward_ms,
              plain_ms=plain_ms, sdpa_baseline_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
              prep_bound_ms=qk_prep_bound(q, k, cs)[0], tflops=4 * n * sq * kv_eff * h / ms / 1e9, card=card)
        if not (all(e["err_over_max1_ref"] <= K1_TOL and e["lse_max_abs_err"] <= LSE_TOL for e in errs.values())
                and empty_zero and past_lens_ok is not False):
            raise AssertionError(f"K1 disagrees with its reference on {name}: {errs}, empty rows zero {empty_zero}, "
                                 f"rows past kv_lens ignored {past_lens_ok}")
        worst = max(worst, errs["plain"]["max_abs_err"], errs["flash_attention_reference"]["max_abs_err"])
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                             prep_ms=prep_ms, flash_forward_ms=forward_ms)
        del q, k, v, q_s, k_r, out, core_out
    return worst, records


def _by_head(fn, n, tensors, tables):
    """`fn(*tensors, *tables)` one head at a time, the results joined along the
    head dim: `tensors` are BNSH or (B, N, S) and are cut on dim 1, `tables`
    (N or 1, S, H) on dim 0 unless shared. The plain backward at Wan's shape
    would need ~80 GB of fp32 scores for all heads at once."""
    def table(t, i):
        return t if t is None or t.shape[0] == 1 else t[i:i + 1]

    outs = [fn(*(x[:, i:i + 1] for x in tensors), *(table(t, i) for t in tables)) for i in range(n)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def check_k2k3(card, cases=None, phase_name="k2k3_check"):
    """The pre-pass, K2 and K3 against their plain versions at the training
    paths' shapes (by default: LTX's self-attention with per-head tables,
    LTX's cross-attention with kv_lens, a ragged case with an empty row, H=128
    with shared tables, and Wan's training self-attention (shared Wan tables)
    and cross-attention (kv_lens [512]) at full width), the cases over 4096^2
    held against `flash_backward_reference` one head at a time. Returns the
    worst errors and the records by case."""
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = cases or {
        "self_rope": dict(b=1, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "cross_kv_lens": dict(b=1, n=32, sq=2688, skv=128, h=64, lens=[37], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
        "h128_shared_rope": dict(b=1, n=12, sq=4096, skv=4096, h=128, lens=None, rope="shared"),
        "wan_train_self_shared_rope": dict(b=1, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
        "wan_train_cross_kv_lens": dict(b=1, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "wan_run_self_shared_rope": dict(b=1, n=12, sq=WAN_RUN_TOKENS, skv=WAN_RUN_TOKENS, h=128, lens=None,
                                         rope="wan_run"),
        "wan_run_cross_kv_lens": dict(b=1, n=12, sq=WAN_RUN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "i2v_train_self_shared_rope": dict(b=1, n=I2V_HEADS, sq=WAN_RUN_TOKENS, skv=WAN_RUN_TOKENS, h=128, lens=None,
                                           rope="wan_run"),
        "i2v_train_cross_kv_lens": dict(b=1, n=I2V_HEADS, sq=WAN_RUN_TOKENS, skv=512, h=128, lens=[512], rope=None),
    }
    worst = {"prep": 0.0, "k2": 0.0, "k3": 0.0}
    records = {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v, do, lens, cos, sin = _bwd_case_inputs(c, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        by_head = sq * skv > 4096 * 4096
        out, lse = flash_forward(q, k, v, lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)

        grads = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        q_s, k_r = flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        torch.cuda.synchronize()
        if by_head:
            refs = _by_head(lambda *a: flash_backward_reference(*a[:6], lens, *a[6:]), n, (q, k, v, out, lse, do),
                            (cos, sin))
        else:
            refs = flash_backward_reference(q, k, v, out, lse, do, lens, cos, sin)
        ref_qs, ref_kr = flash_qk_prep_reference(q, k, cos, sin, scale)
        errors = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs)}
        errors["q_s"] = rel_errors(q_s, ref_qs)
        if cos is not None:
            errors["k_r"] = rel_errors(k_r, ref_kr)
        finite = all(bool(torch.isfinite(x).all()) for x in (*grads, q_s, k_r))
        del refs, ref_qs, ref_kr

        operands = (q_s, k_r, v, do, lse, delta, lens, cos, sin)

        def plain_k2():
            if by_head:
                return _by_head(lambda *a: flash_bwd_dkdv_reference(*a[:6], lens, *a[6:]), n, operands[:6], (cos, sin))
            return flash_bwd_dkdv_reference(*operands)

        def plain_k3():
            if by_head:
                return _by_head(lambda *a: (flash_bwd_dq_reference(*a[:6], lens, *a[6:], scale),), n,
                                operands[:6], (cos, sin))
            return flash_bwd_dq_reference(*operands, scale)

        plain_iters = 1 if by_head else 3
        prep_ms = cuda_ms(lambda: flash_qk_prep(q, k, cos, sin, rope_sn, scale))
        prep_plain_ms = cuda_ms(lambda: flash_qk_prep_reference(q, k, cos, sin, scale))
        k2_ms = cuda_ms(lambda: flash_bwd_dkdv(*operands, rope_sn))
        k3_ms = cuda_ms(lambda: flash_bwd_dq(*operands, rope_sn, scale))
        k2_device_ms = device_ms(lambda: flash_bwd_dkdv(*operands, rope_sn), k2_kernels(q_s, k_r))
        k3_device_ms = device_ms(lambda: flash_bwd_dq(*operands, rope_sn, scale), K3_KERNELS)
        backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        k2_plain_ms = cuda_ms(plain_k2, iters=plain_iters, warmup=plain_iters - 1)
        k3_plain_ms = cuda_ms(plain_k3, iters=plain_iters, warmup=plain_iters - 1)
        # torch SDPA's backward (dq, dk, dv in one call, no fused rotation): a library yardstick only.
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        del sdpa_out, leaves

        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        k2_bound, k3_bound = bwd_bounds(b, n, sq, skv, kv_eff, h, cos)
        prep_bound = bound(0, 2 * b * n * sq * h * 2 + (2 * b * n * skv * h * 2 + 2 * cos.numel() * 4
                                                        if cos is not None else 0))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = dkdv_splits(b, n, sq, skv, sms)
        # Where a kv tile lies wholly past kv_lens (HunyuanVideo's refiner), dk and dv are exactly 0 at every key
        # at or past kv_lens[b]: under a split q loop the reduce pass writes them.
        zero_past_lens = None
        if c.get("dead_tile"):
            zero_past_lens = all(not x[bi, :, length:].any() for x in grads[1:] for bi, length in enumerate(c["lens"]))
        reduce = None
        if splits[0] > 1:  # the reduce pass alone: its device time in a K2 call, its plain version and bound
            partial_gen = torch.Generator(device="cuda").manual_seed(2)  # `g`'s draws for later cases stay as they were
            partials = torch.randn((2, splits[0], b, n, skv, h), generator=partial_gen, device="cuda")
            reduce_plain_ms = cuda_ms(lambda: plain_dkdv_reduce(partials, lens, q.dtype))
            reduce_device_ms = device_ms(lambda: flash_bwd_dkdv(*operands, rope_sn), K2_KERNELS[1:])
            (reduce_bound_ms, reduce_by), _ = dkdv_reduce_bound(b, n, sq, skv, h, sms)
            reduce = (reduce_device_ms, reduce_plain_ms, None, reduce_bound_ms, reduce_by)
            del partials
        phase(phase_name, case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              zero_past_kv_lens=zero_past_lens,
              reduce_pass=None if reduce is None else dict(zip(("device_ms", "plain_ms", "library_ms", "bound_ms",
                                                                "bound_by"), reduce)),
              plain_by_head=by_head, k2_splits=splits[0], rel_l2={k_: e[0] for k_, e in errors.items()},
              max_err_over_max_ref={k_: e[1] for k_, e in errors.items()},
              max_abs_err={k_: e[2] for k_, e in errors.items()}, finite=finite,
              prep_ms=prep_ms, prep_plain_ms=prep_plain_ms, k2_ms=k2_ms, k3_ms=k3_ms, k2_device_ms=k2_device_ms,
              k3_device_ms=k3_device_ms, flash_backward_ms=backward_ms, k2_plain_ms=k2_plain_ms,
              k3_plain_ms=k3_plain_ms, sdpa_backward_ms=sdpa_bwd_ms, k2_bound_ms=k2_bound[0], k3_bound_ms=k3_bound[0],
              k2_bound_by=k2_bound[1], k3_bound_by=k3_bound[1], prep_bound_ms=prep_bound[0],
              k2_tflops=8 * n * sq * kv_eff * h / k2_ms / 1e9, k3_tflops=6 * n * sq * kv_eff * h / k3_ms / 1e9,
              card=card)
        bad = [k_ for k_, e in errors.items() if not (e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL)]
        if bad or not finite:
            raise AssertionError(f"the backward kernels disagree with their reference on {name}: {bad}, "
                                 f"finite={finite}")
        if c["lens"] is not None and 0 in c["lens"]:
            empty = c["lens"].index(0)
            if any(x[empty].any() for x in grads):
                raise AssertionError(f"{name}: a batch with no valid key got a nonzero gradient")
        if zero_past_lens is False:
            raise AssertionError(f"{name}: dk or dv is nonzero at a key past kv_lens")
        worst["prep"] = max(worst["prep"], errors["q_s"][2], errors.get("k_r", (0, 0, 0))[2])
        worst["k2"] = max(worst["k2"], errors["dk"][2], errors["dv"][2])
        worst["k3"] = max(worst["k3"], errors["dq"][2])
        records[name] = dict(prep=(prep_ms, prep_plain_ms, None, *prep_bound),
                             k2=(k2_ms, k2_plain_ms, sdpa_bwd_ms, *k2_bound),
                             k3=(k3_ms, k3_plain_ms, sdpa_bwd_ms, *k3_bound),
                             k2_device_ms=k2_device_ms, k3_device_ms=k3_device_ms, reduce=reduce)
        del q, k, v, do, out, lse, delta, grads, q_s, k_r, operands
    return worst, records


def wan_tables(grid=WAN_GRID):
    """Wan's expanded (S, 128) fp32 RoPE tables at `grid` (the serving grid by default), as the model builds them."""
    return WanRotaryPosEmbed(128)(*grid, torch.device("cuda"))


def k6_bound(n, sq, kv_eff, h, q_rows):
    """K6's least time: QK^T at the int8 peak plus P V at the bf16 peak, against
    the bytes of codes, scales, v and out read or written once."""
    ops_ms = (2 * n * sq * kv_eff * h / PEAK_INT8_OPS + 2 * n * sq * kv_eff * h / PEAK_BF16_FLOPS) * 1e3
    nbytes = q_rows * n * h * (1 + 2) + q_rows * n * 4 + n * kv_eff * (h + 4 + 2 * h)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_prepass(q, k, lens, codes, cos=None, sin=None, heads=None):
    """The pre-pass kernel's codes and scales against the plain pre-pass on the
    CPU copy: q codes and scales equal, k codes within one and different in at
    most 0.1% of entries (the smoothed k's mean is summed in another order), k
    scales within rtol 1e-5. With `heads` (a list of head indices) only those
    heads are compared: quantization is per token and smooth-K's mean per
    (batch, head), so a head's codes depend on that head's q and k alone.
    Returns (largest code difference, share of k codes that differ, max k
    scale relative error)."""
    if heads is not None:
        q, k = q[:, :, heads], k[:, :, heads]
        codes = tuple(x[:, heads] for x in codes)
        if cos is not None and cos.shape[0] > 1:
            cos, sin = cos[heads], sin[heads]
    cpu = sage_quantize(q.cpu(), k.cpu(), lens.cpu(), *(None if t is None else t.cpu() for t in (cos, sin)))
    if not (torch.equal(codes[0].cpu(), cpu[0]) and torch.equal(codes[2].cpu(), cpu[2])):
        raise AssertionError("the pre-pass's q codes or scales differ between the card and the CPU")
    diff = (codes[1].cpu().int() - cpu[1].int()).abs()
    share = (diff > 0).float().mean().item()
    scale_err = ((codes[3].cpu() - cpu[3]).abs() / cpu[3]).max().item()
    if diff.max() > 1 or share > 1e-3 or scale_err > 1e-5:
        raise AssertionError(f"the pre-pass's k codes differ: max {diff.max().item()}, share {share}, "
                             f"scale rel err {scale_err}")
    return diff.max().item(), share, scale_err


def prepass_bound(q, k, cos):
    """The pre-pass's least time (ms, "bytes"): q and k read, their int8 codes
    and fp32 per-token scales written, and the tables read, once each."""
    elems = q.numel() + k.numel()
    tokens = elems // q.shape[-1]
    table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
    return bound(0, elems * 2 + elems + tokens * 4 + table_bytes)


def check_k6(card, cases=None, phase_name="k6_check"):
    """The pre-pass kernel and K6 against their plain versions: the codes
    `sage_prep` writes on the card against `sage_quantize` on the CPU copy, and
    K6 against `sage_attention_reference` on the same codes and scales, by
    default at Wan's and LTX's serving shapes (a case's `rope`: True for Wan's
    tables at its grid, a (cos, sin) pair of (1, S, H) tables, or False). At
    H=32 the bounds also count one exponential per score (`exp_bound`).
    Returns the worst K6 error, the worst code difference and the records by
    case."""
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = cases or {
        "wan_self_rope": dict(b=2, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope=True),
        "wan_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[1, 9], rope=False),
        "ltx_self": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope=False),
        "ragged_empty_row": dict(b=2, n=4, sq=1000, skv=77, h=128, lens=[77, 0], rope=False),
        "ragged_empty_row_h64": dict(b=2, n=4, sq=1000, skv=333, h=64, lens=[200, 0], rope=False),
        # Wan I2V serving: self-attention at 81x480x832 (the pre-pass's codes held against the plain pre-pass
        # on the first and last heads, not on all of its 2 x 335M values) and the image branch, 257 keys, no
        # kv_lens.
        "i2v_self_rope": dict(b=2, n=I2V_HEADS, sq=I2V_SERVE_TOKENS, skv=I2V_SERVE_TOKENS, h=128, lens=None,
                              rope=True, grid=I2V_SERVE_GRID, prep_heads=[0, I2V_HEADS - 1]),
        "i2v_image_cross": dict(b=2, n=I2V_HEADS, sq=I2V_SERVE_TOKENS, skv=I2V_IMAGE_TOKENS, h=128, lens=None,
                                rope=False),
    }
    worst, worst_code, records = 0.0, 0, {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        # BTNH, as the model hands them over; k with a per-channel offset, which smooth-K removes.
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, skv, skv))
        k = k + torch.randn(1, 1, n, h, generator=g, device="cuda").to(torch.bfloat16)
        if isinstance(c["rope"], tuple):
            cos, sin = c["rope"]
        else:
            cos, sin = (t[None].contiguous() for t in wan_tables(c.get("grid", WAN_GRID))) if c["rope"] else (None, None)
        lens = torch.tensor(c["lens"] or [skv] * b, dtype=torch.int32, device="cuda")
        vt = v.transpose(1, 2)
        codes = sage_prep(q, k, lens, cos, sin)
        out = sage_forward(*codes, vt, lens)
        torch.cuda.synchronize()
        ref, plain_ms = timed_call(lambda: sage_attention_reference(*codes, vt, lens))
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        norm_err = (err / ref.float().abs().clamp_min(1.0)).max().item()
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
        code_diff, code_share, scale_err = check_prepass(q, k, lens, codes, cos, sin, c.get("prep_heads"))
        ms = cuda_ms(lambda: sage_forward(*codes, vt, lens))
        prep_ms = cuda_ms(lambda: sage_prep(q, k, lens, cos, sin))
        # The plain pre-pass on the card: the torch rotation and quantization the parent ran before K6.
        prep_plain_ms = cuda_ms(lambda: sage_quantize(q, k, lens, cos, sin))
        # torch SDPA on the bf16 inputs (no quantization, no rotation): a library yardstick only, never called
        # by the port.
        mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=None if c["lens"] is None
                                                                 else mask))
        kv_eff = int(lens.sum())
        bound_ms, bound_by = k6_bound(n, sq, kv_eff, h, b * sq)
        if h == 32:
            bound_ms, bound_by = exp_bound((bound_ms, bound_by), n * sq * kv_eff)
        prep_bound_ms, _ = prepass_bound(q, k, cos)
        phase(phase_name, case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=cos is not None,
              max_abs_err=max_abs, err_over_max1_ref=norm_err, rel_l2=rel_l2, empty_rows_zero=empty_zero,
              prep_max_code_diff=code_diff, prep_k_codes_differing=code_share, prep_k_scale_rel_err=scale_err,
              prep_heads_checked=c.get("prep_heads", "all"),
              ms=ms, plain_ms=plain_ms, sdpa_yardstick_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
              tops_equivalent=4 * n * sq * kv_eff * h / ms / 1e9, prep_ms=prep_ms, prep_plain_ms=prep_plain_ms,
              prep_bound_ms=prep_bound_ms, card=card)
        if not (norm_err <= K6_TOL and rel_l2 <= K6_REL_L2_TOL and empty_zero):
            raise AssertionError(f"K6 disagrees with its reference on {name}: {norm_err} > {K6_TOL}, "
                                 f"rel L2 {rel_l2} > {K6_REL_L2_TOL} or an empty row is not zero")
        worst, worst_code = max(worst, max_abs), max(worst_code, code_diff)
        records[name] = dict(k6=(ms, plain_ms, sdpa_ms, bound_ms, bound_by),
                             prep=(prep_ms, prep_plain_ms, None, prep_bound_ms, "bytes"))
        del q, k, v, vt, codes, out, ref, err
    return worst, worst_code, records


def check_k1_wan(card, cases=None, phase_name="k1_check"):
    """The pre-pass and K1 at self-attention shapes with one (S, H) table pair
    shared by every head (H from the tables), against their plain version run one head at a time
    (all heads at once would need ~100 GB of fp32 scores). By default Wan's:
    serving (B=2, S=19968), the example's bucket (B=1, S=20280, whose last q
    and kv tiles hold 56 rows), I2V-14B training at that bucket (B=1, 40
    heads) and I2V-14B serving (B=2, 40 heads, S=32760, last tiles of 120
    rows); `cases` maps a name to (B, N, a function giving the (1, S, H)
    tables). K1 is timed alone and with its pre-pass. Returns the worst error
    and the records by case."""
    g = torch.Generator(device="cuda").manual_seed(8)

    def wan(grid):
        return lambda: tuple(t[None].contiguous() for t in wan_tables(grid))

    cases = cases or {"wan_self_rope_shared_tables": (2, 12, wan(WAN_GRID)),
                      "wan_run_self_rope_shared_tables": (1, 12, wan(WAN_RUN_GRID)),
                      "i2v_train_self_rope_shared_tables": (1, I2V_HEADS, wan(WAN_RUN_GRID)),
                      "i2v_serve_self_rope_shared_tables": (2, I2V_HEADS, wan(I2V_SERVE_GRID))}
    worst, records = 0.0, {}
    for name, (b, n, tables) in cases.items():
        cos, sin = tables()
        s, h = cos.shape[1], cos.shape[2]
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        out, lse = flash_forward(q, k, v, None, cos, sin)
        torch.cuda.synchronize()

        def plain():
            ref, ref_lse = torch.empty_like(out), torch.empty_like(lse)
            for bi in range(b):
                for ni in range(n):
                    o, l_ = flash_attention_reference(q[bi:bi + 1, ni:ni + 1], k[bi:bi + 1, ni:ni + 1],
                                                      v[bi:bi + 1, ni:ni + 1], None, cos, sin)
                    ref[bi, ni], ref_lse[bi, ni] = o[0, 0], l_[0, 0]
            return ref, ref_lse

        (ref, ref_lse), plain_ms = timed_call(plain)
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        norm_err = (err / ref.float().abs().clamp_min(1.0)).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        q_s, k_r = flash_qk_prep(q, k, cos, sin, 0, h**-0.5)
        ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v))
        prep_ms = cuda_ms(lambda: flash_qk_prep(q, k, cos, sin, 0, h**-0.5))
        prep_plain_ms = cuda_ms(lambda: flash_qk_prep_reference(q, k, cos, sin, h**-0.5), iters=3)
        forward_ms = cuda_ms(lambda: flash_forward(q, k, v, None, cos, sin))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: attention_dispatch(qt, kt, vt, provider="native"))
        flops = 4 * b * n * s * s * h
        bound_ms, bound_by = k1_bound(b, n, s, b * s, h)
        phase(phase_name, case=name, shape=[b, n, s, s, h], max_abs_err=max_abs, err_over_max1_ref=norm_err,
              rel_l2=rel_l2, lse_max_abs_err=lse_err, ms=ms, prep_ms=prep_ms, flash_forward_ms=forward_ms,
              plain_ms=plain_ms, sdpa_baseline_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
              prep_plain_ms=prep_plain_ms, prep_bound_ms=qk_prep_bound(q, k, cos)[0], tflops=flops / ms / 1e9,
              card=card)
        if not (norm_err <= K1_TOL and rel_l2 <= K1_REL_L2_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"K1 disagrees with its reference on {name}: {norm_err}, rel L2 {rel_l2} "
                                 f"or LSE {lse_err}")
        worst = max(worst, max_abs)
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                             prep_ms=prep_ms, prep_plain_ms=prep_plain_ms, flash_forward_ms=forward_ms)
        del q, k, v, q_s, k_r, out, ref, err, qt, kt, vt
    return worst, records


def _bwd_case_inputs(c, g):
    """q, k, v, dO (BNSH views of BTNH buffers), kv_lens and tables of a backward case."""
    b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
    q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
               for s in (sq, skv, skv))
    do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
    lens = None if c["lens"] is None else torch.tensor(c["lens"], dtype=torch.int32, device="cuda")
    cos = sin = None
    if c["rope"] == "ltx":
        cos, sin = ltx_tables(n, h)
    elif c["rope"] in ("wan", "wan_run"):
        cos, sin = (t[None].contiguous() for t in wan_tables(WAN_GRID if c["rope"] == "wan" else WAN_RUN_GRID))
    elif c["rope"] == "flux":
        cos, sin = flux_tables(*c["latent"])
    elif c["rope"] == "hunyuan":
        cos, sin = hunyuan_tables(HUNYUAN_RUN_GRID)
    elif c["rope"] == "cogview4":
        cos, sin = cogview4_tables()
    elif c["rope"] == "cogvideox":
        cos, sin = cogvideox_tables()
    elif c["rope"] == "shared":
        ang = torch.rand(1, sq, h // 2, generator=g, device="cuda") * 6.3
        cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    return q, k, v, do, lens, cos, sin


def check_k5(card, cases=None, phase_name="k5_check"):
    """K5 and its dq emit (after the pre-pass) against K5's plain version and
    against K2+K3, by default at the training paths' shapes, including Wan's
    (at H=32 the bounds also count one exponential per score); returns the
    worst errors and the records by case (K5, emit, and K1 at the case's
    shape)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = cases or {
        "ltx_self_rope": dict(b=1, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "ltx_cross_kv_lens": dict(b=1, n=32, sq=2688, skv=128, h=64, lens=[37], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
        "wan_self_shared_rope": dict(b=1, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
    }
    worst = {"k5": 0.0, "k5_emit": 0.0}
    records = {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v, do, lens, cos, sin = _bwd_case_inputs(c, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        out, lse = flash_forward(q, k, v, lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)
        with switch("FINETRAINERS_FLASH_FUSED_BWD"):
            fused = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        split = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        q_s, k_r = flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        dq_acc, _, _ = flash_bwd_fused(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn)
        emitted = flash_bwd_dq_emit(dq_acc, cos, sin, rope_sn, scale, q.dtype)
        torch.cuda.synchronize()
        refs = flash_backward_fused_reference(q, k, v, out, lse, do, lens, cos, sin)

        def emit_plain():
            dq = dq_acc * scale
            return (dq if cos is None else _rope_bwd(dq, cos, sin)).to(q.dtype)

        errors = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), fused, refs)}
        vs_split = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), fused, split)}
        emit_errors = rel_errors(emitted, emit_plain())
        finite = all(bool(torch.isfinite(x).all()) for x in fused)

        k5_ms = cuda_ms(lambda: flash_bwd_fused(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn))
        emit_ms = cuda_ms(lambda: flash_bwd_dq_emit(dq_acc, cos, sin, rope_sn, scale, q.dtype))
        emit_plain_ms = cuda_ms(emit_plain)
        with switch("FINETRAINERS_FLASH_FUSED_BWD"):
            fused_backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        split_backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        k2_ms = cuda_ms(lambda: flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn))
        k3_ms = cuda_ms(lambda: flash_bwd_dq(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn, scale))
        k1_ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v, lens))
        plain_ms = cuda_ms(lambda: flash_backward_fused_reference(q, k, v, out, lse, do, lens, cos, sin),
                           iters=1, warmup=0)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        del sdpa_out, leaves

        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        q_bytes, table_bytes = b * n * sq * h * 2, 2 * cos.numel() * 4 if cos is not None else 0
        k5_b = k5_bound(b, n, sq, skv, kv_eff, h, cos)
        if h == 32:
            k5_b = exp_bound(k5_b, n * sq * kv_eff)
        emit_bound = bound(0, 2 * q_bytes + q_bytes + table_bytes)
        k2_bound, k3_bound = bwd_bounds(b, n, sq, skv, kv_eff, h, cos)
        k1_b = k1_bound(b, n, sq, kv_eff, h)
        phase(phase_name, case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              rel_l2={k_: e[0] for k_, e in errors.items()}, max_err_over_max_ref={k_: e[1] for k_, e in errors.items()},
              max_abs_err={k_: e[2] for k_, e in errors.items()},
              vs_k2k3_rel_l2={k_: e[0] for k_, e in vs_split.items()},
              vs_k2k3_max_err_over_max_ref={k_: e[1] for k_, e in vs_split.items()},
              emit_rel_l2=emit_errors[0], emit_max_abs_err=emit_errors[2], finite=finite, k5_ms=k5_ms, emit_ms=emit_ms, emit_plain_ms=emit_plain_ms,
              fused_backward_ms=fused_backward_ms, k2k3_backward_ms=split_backward_ms, k2_ms=k2_ms, k3_ms=k3_ms,
              k1_ms=k1_ms, plain_ms=plain_ms, sdpa_backward_ms=sdpa_bwd_ms, sdpa_forward_ms=sdpa_fwd_ms,
              k5_bound_ms=k5_b[0], emit_bound_ms=emit_bound[0], k2_bound_ms=k2_bound[0],
              k3_bound_ms=k3_bound[0], k1_bound_ms=k1_b[0],
              k5_tflops=10 * n * sq * kv_eff * h / k5_ms / 1e9, card=card)
        bad = [k_ for k_, e in {**errors, **{f"{k_}_vs_k2k3": e for k_, e in vs_split.items()},
                                 "emit": emit_errors}.items()
               if not (e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL)]
        if bad or not finite:
            raise AssertionError(f"K5 disagrees on {name}: {bad}, finite={finite}")
        if c["lens"] is not None and 0 in c["lens"]:
            empty = c["lens"].index(0)
            if any(x[empty].any() for x in fused):
                raise AssertionError(f"{name}: a batch with no valid key got a nonzero gradient from K5")
        worst["k5"] = max(worst["k5"], *(e[2] for e in errors.values()))
        worst["k5_emit"] = max(worst["k5_emit"], emit_errors[2])
        records[name] = dict(
            k5=(k5_ms, plain_ms, sdpa_bwd_ms, *k5_b), k5_emit=(emit_ms, emit_plain_ms, None, *emit_bound),
            k1=(k1_ms, None, sdpa_fwd_ms, *k1_b), fused_backward_ms=fused_backward_ms)
        del q, k, v, do, out, lse, fused, split, q_s, k_r, dq_acc, emitted, refs
    return worst, records


# name: (kernel, plain version). Each computes K1's function, so each bound counts K1's two products
# (QK^T, PV); K7a's second QK^T sweep is its own algorithm's cost and shows in its time against K1's.
K7_KERNELS = {
    "k7a": (flash_forward_twopass, flash_forward_twopass_reference),
    "k7b": (flash_forward_skew, flash_forward_skew_reference),
    "k7c": (flash_forward_two_level, flash_forward_two_level_reference),
}


def check_k7(card, cases=None, phase_name="k7_check"):
    """K7a, K7b and K7c against their plain versions and against K1, in bf16,
    by default at LTX's serving self-attention, Wan's self- and
    cross-attention at the training path's batch (1) and the serving batch
    (2), and a ragged case with an empty row (K7b takes no RoPE tables: its
    self-attention cases run without them, as does the K1 it is held against).
    Where kv_lens leaves k/v rows out, filling them with large values must
    leave out and LSE bit-equal to the call with them zeroed (TMA reads those
    rows). At H=32 the bounds also count one exponential per score. Returns
    the worst errors and each kernel's records by case."""
    g = torch.Generator(device="cuda").manual_seed(10)
    cases = cases or {
        "ltx_self_rope": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "wan_train_self_shared_rope": dict(b=1, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
        "wan_train_cross_kv_lens": dict(b=1, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "wan_self_shared_rope": dict(b=2, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
        "wan_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512, 9], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
    }
    worst = {name: 0.0 for name in K7_KERNELS}
    records = {name: {} for name in K7_KERNELS}
    for case, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v, _, lens, case_cos, case_sin = _bwd_case_inputs(c, g)
        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        k1_runs = {}
        for name, (kernel, reference) in K7_KERNELS.items():
            cos, sin = (None, None) if name == "k7b" else (case_cos, case_sin)
            if (cos is None) not in k1_runs:  # K1 on the same call, and its time
                k1_runs[cos is None] = (*flash_forward(q, k, v, lens, cos, sin),
                                        cuda_ms(lambda: flash_forward(q, k, v, lens, cos, sin)))
            k1_out, k1_lse, k1_ms = k1_runs[cos is None]
            out, lse = kernel(q, k, v, lens, cos, sin)
            torch.cuda.synchronize()
            ref, ref_lse = reference(q, k, v, lens, cos, sin)
            errs = {}
            for against, (r_out, r_lse) in (("plain", (ref, ref_lse)), ("k1", (k1_out, k1_lse))):
                err = (out.float() - r_out.float()).abs()
                errs[against] = dict(max_abs_err=err.max().item(),
                                     err_over_max1_ref=(err / r_out.float().abs().clamp_min(1.0)).max().item(),
                                     rel_l2=((out.float() - r_out.float()).norm() / r_out.float().norm()).item(),
                                     lse_max_abs_err=(lse - r_lse).abs().max().item())
            empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
            past_lens_ok = None
            if c["lens"] is not None and any(length < skv for length in c["lens"]):
                big = kernel(q, _fill_past_kv_lens(k, c["lens"], 3e4), _fill_past_kv_lens(v, c["lens"], -3e4), lens,
                             cos, sin)
                zeroed = kernel(q, _fill_past_kv_lens(k, c["lens"], 0.0), _fill_past_kv_lens(v, c["lens"], 0.0), lens,
                                cos, sin)
                past_lens_ok = torch.equal(big[0], zeroed[0]) and torch.equal(big[1], zeroed[1])
                del big, zeroed
            ms = cuda_ms(lambda: kernel(q, k, v, lens, cos, sin))
            plain_ms = cuda_ms(lambda: reference(q, k, v, lens, cos, sin), iters=1, warmup=0)
            flops = 4 * n * sq * kv_eff * h
            table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
            bound_ms, bound_by = bound(flops, 2 * b * n * sq * h * 2 + 2 * n * kv_eff * h * 2 + b * n * sq * 4
                                       + table_bytes)
            if h == 32:
                bound_ms, bound_by = exp_bound((bound_ms, bound_by), n * sq * kv_eff)
            phase(phase_name, kernel=name, case=case, shape=[b, n, sq, skv, h], kv_lens=c["lens"],
                  rope=None if cos is None else c["rope"], vs_plain=errs["plain"], vs_k1=errs["k1"],
                  empty_rows_zero=empty_zero, rows_past_kv_lens_ignored=past_lens_ok, ms=ms, k1_ms=k1_ms,
                  plain_ms=plain_ms, sdpa_forward_ms=sdpa_ms,
                  bound_ms=bound_ms,
                  bound_by=bound_by, tflops=flops / ms / 1e9, card=card)
            ok = all(e["err_over_max1_ref"] <= K1_TOL and e["lse_max_abs_err"] <= LSE_TOL
                     and e["rel_l2"] <= K1_REL_L2_TOL for e in errs.values())
            if not (ok and empty_zero and past_lens_ok is not False):
                raise AssertionError(f"{name} disagrees on {case}: {errs}, empty rows zero: {empty_zero}, "
                                     f"rows past kv_lens ignored: {past_lens_ok}")
            worst[name] = max(worst[name], errs["plain"]["max_abs_err"])
            records[name][case] = dict(ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
            del out, lse, ref, ref_lse
        del q, k, v, k1_runs
    return worst, records


def serve(card):
    """The serving path; returns K1's launches there."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("ltx_video", "lora")(device=torch.device("cuda"), seed=0)
    pipe = spec.load_pipeline()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.transformer.module.parameters())
    phase("load", seconds=time.perf_counter() - t0, transformer_params=n_params,
          layers=len(pipe.transformer.module.transformer_blocks))
    if n_params != BASE_PARAMS or len(pipe.transformer.module.transformer_blocks) != NUM_LAYERS:
        raise AssertionError("the spec did not build the published LTX-Video width and depth")

    phase("serve_config", steps=NUM_STEPS, steps_note="cut from the default 50", **REQUEST)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    videos, request_s = [], []
    for seed, prompt in enumerate(PROMPTS):
        t0 = time.perf_counter()
        videos.append(pipe(prompt=prompt, seed=seed, **REQUEST))
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
    counts = _counts()
    launches = counts["k1"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 2 * NUM_LAYERS * NUM_STEPS * len(PROMPTS)
    # LTX_VAE_CONFIG's decoder uses four of its five spatial flags, so a 49x512x768
    # request decodes to 49x256x384, as in the JAX package (ROADMAP.md).
    shape_ok = all(v.shape == (49, 256, 384, 3) and v.dtype == np.uint8 for v in videos)
    differ = not np.array_equal(videos[0], videos[1])
    phase("serve", requests=len(PROMPTS), video_shape=list(videos[0].shape), dtype=str(videos[0].dtype),
          videos_differ=differ, launches=counts, k1_and_prep_launches_expected=expected,
          request_seconds=request_s, peak_memory_gb=peak_gb, card=card)
    if not (shape_ok and differ and counts == {k_: expected if k_ in ("k1", "prep") else 0 for k_ in counts}):
        raise AssertionError("serving check failed")

    ehs, mask = pipe.encode_prompt(PROMPTS[0], None, True)
    latents = torch.randn(pipe.latent_shape(49, 512, 768), generator=torch.Generator("cuda").manual_seed(7),
                          device="cuda")
    sigma = float(pipe.scheduler.inference_sigmas(NUM_STEPS)[1])
    rope_scale = (1.0 / (25 / 8), 32.0, 32.0)
    with torch.inference_mode():
        step = lambda: pipe.denoise_step(latents, ehs, mask, 3.0, sigma, rope_scale)  # noqa: E731
        kernel_out = step()
        with attention_provider("_native_math"):
            plain_out = step()
            plain_step_ms = cuda_ms(step, iters=3, warmup=1)
        with attention_provider("native"):  # torch SDPA, the library baseline, for comparison only
            sdpa_out = step()
            sdpa_step_ms = cuda_ms(step, iters=5, warmup=1)
        step_ms = cuda_ms(step, iters=5, warmup=1)
        prof = profile_device(step)
    rel_l2 = ((kernel_out - plain_out).norm() / plain_out.norm()).item()
    sdpa_rel_l2 = ((sdpa_out - plain_out).norm() / plain_out.norm()).item()
    phase("step_vs_plain_attention", rel_l2=rel_l2, bound=STEP_REL_L2_TOL, sdpa_baseline_rel_l2=sdpa_rel_l2,
          finite=bool(torch.isfinite(kernel_out).all()))
    if not (rel_l2 <= STEP_REL_L2_TOL and torch.isfinite(kernel_out).all()):
        raise AssertionError(f"denoise step with K1 differs from plain attention: rel L2 {rel_l2}")

    phase("timing", card=card, denoise_step_s=step_ms / 1e3, denoise_step_plain_attention_s=plain_step_ms / 1e3,
          request_s=statistics.mean(request_s), requests_s=request_s, steps_per_request=NUM_STEPS,
          peak_memory_gb=peak_gb, denoise_step_sdpa_baseline_s=sdpa_step_ms / 1e3)
    classes, per_launch = forward_classes(prof)
    phase("profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return counts


def wan_serve(card):
    """The Wan serving path under `sage`, then under the default provider;
    returns the kernel launches of those runs."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0)
    pipe = spec.load_pipeline()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.transformer.module.parameters())
    phase("wan_load", seconds=time.perf_counter() - t0, transformer_params=n_params,
          layers=len(pipe.transformer.module.blocks))
    if n_params != WAN_PARAMS or len(pipe.transformer.module.blocks) != WAN_LAYERS:
        raise AssertionError("the spec did not build the published Wan 2.1 T2V-1.3B width and depth")

    def run(provider, prompts):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        videos, request_s = [], []
        with attention_provider(provider):
            for seed, prompt in enumerate(prompts):
                t0 = time.perf_counter()
                videos.append(pipe(prompt=prompt, seed=seed, **WAN_REQUEST))
                torch.cuda.synchronize()
                request_s.append(time.perf_counter() - t0)
        return videos, request_s, _counts(), torch.cuda.max_memory_allocated() / 1e9

    phase("wan_serve_config", steps=WAN_STEPS, steps_note="cut from the default 50", tokens=WAN_TOKENS,
          text_tokens=512, **WAN_REQUEST)
    with counted(attention_ops, "_rotate_interleaved_4d") as rotations:
        videos, request_s, launches, peak_gb = run("sage", PROMPTS)
    per_request = 2 * WAN_LAYERS * WAN_STEPS
    shape_ok = all(v.shape == (49, 512, 768, 3) and v.dtype == np.uint8 for v in videos)
    differ = not np.array_equal(videos[0], videos[1])
    # Every attention call launches the pre-pass, then K6; nothing rotates q or k in torch.
    phase("wan_serve", provider="sage", requests=len(PROMPTS), video_shape=list(videos[0].shape),
          dtype=str(videos[0].dtype), videos_differ=differ, launches=launches,
          k6_and_sage_prep_launches_expected=per_request * len(PROMPTS), torch_rotations=rotations[0],
          request_seconds=request_s, peak_memory_gb=peak_gb, card=card)
    if not (shape_ok and differ and rotations[0] == 0
            and launches == {k_: per_request * len(PROMPTS) if k_ in ("k6", "sage_prep") else 0
                             for k_ in launches}):
        raise AssertionError("Wan serving under sage failed its checks")
    sage_launches = launches
    del videos

    videos, auto_request_s, launches, auto_peak_gb = run("auto", PROMPTS[:1])
    phase("wan_serve", provider="auto", requests=1, video_shape=list(videos[0].shape), launches=launches,
          k1_launches_expected=per_request, request_seconds=auto_request_s, peak_memory_gb=auto_peak_gb, card=card)
    if not (videos[0].shape == (49, 512, 768, 3)
            and launches == {k_: per_request if k_ in ("k1", "prep") else 0 for k_ in launches}):
        raise AssertionError("Wan serving under the default provider failed its checks")
    auto_launches = launches
    del videos

    ehs, mask, _ = pipe.encode_prompt(PROMPTS[0], None, True)
    latents = torch.randn(pipe.latent_shape(49, 512, 768), generator=torch.Generator("cuda").manual_seed(7),
                          device="cuda")
    sigma = float(pipe.scheduler.inference_sigmas(WAN_STEPS)[1])
    with torch.inference_mode():
        step = lambda: pipe.denoise_step(latents, ehs, mask, WAN_REQUEST["guidance_scale"], sigma)  # noqa: E731
        k1_out = step()
        k1_step_ms = cuda_ms(step, iters=3, warmup=1)
        k1_prof = profile_device(step)
        with attention_provider("sage"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k6_out = step()
            step_peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the transformer alone, without the decode
            k6_step_ms = cuda_ms(step, iters=3, warmup=1)
            with counted(attention_ops, "_rotate_interleaved_4d") as step_rotations:
                prof = profile_device(step)
    rel_l2 = ((k6_out - k1_out).norm() / k1_out.norm()).item()
    finite = bool(torch.isfinite(k6_out).all())
    phase("wan_step_k6_vs_k1", rel_l2=rel_l2, bound=K6_STEP_REL_L2_TOL, finite=finite,
          shape=list(k6_out.shape))
    if not (rel_l2 <= K6_STEP_REL_L2_TOL and finite):
        raise AssertionError(f"a denoise step with K6 differs from the one with K1: rel L2 {rel_l2}")
    phase("wan_timing", card=card, denoise_step_sage_s=k6_step_ms / 1e3, denoise_step_k1_s=k1_step_ms / 1e3,
          request_sage_s=statistics.mean(request_s), requests_sage_s=request_s, request_k1_s=auto_request_s[0],
          steps_per_request=WAN_STEPS, peak_memory_sage_gb=peak_gb, peak_memory_k1_gb=auto_peak_gb,
          peak_memory_sage_step_gb=step_peak_gb)
    # Every block runs the pre-pass and K6 twice, self-attention then cross-attention; the pre-pass is three
    # kernels, counted as one launch.
    k6_self, k6_cross = _split(prof["launches"]["k6"], by_order=True)
    prep = [sum(ms) for ms in zip(*(prof["launches"][cls] for cls in ("sage_prep_sum", "sage_prep_mean",
                                                                      "sage_prep")))]
    prep_self, prep_cross = _split(prep, by_order=True)
    classes = dict(prof["classes"], k6_self_attention=sum(k6_self), k6_cross_attention=sum(k6_cross),
                   sage_prep_self_attention=sum(prep_self), sage_prep_cross_attention=sum(prep_cross))
    phase("wan_profile", card=card, provider="sage", step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, k6_launches=[len(k6_self), len(k6_cross)],
          k6_ms_per_launch={"self_attention": _median(k6_self), "cross_attention": _median(k6_cross)},
          sage_prep_launches=[len(prep_self), len(prep_cross)],
          sage_prep_ms_per_launch={"self_attention": _median(prep_self), "cross_attention": _median(prep_cross)},
          torch_rotations=step_rotations[0], top_kernels_ms=prof["top_kernels_ms"],
          device_events=prof["device_events"])
    if step_rotations[0] or len(k6_self) + len(k6_cross) != 2 * WAN_LAYERS or len(prep) != 2 * WAN_LAYERS:
        raise AssertionError("a profiled sage step did not launch the pre-pass and K6 once per attention, or "
                             "rotated q or k in torch")
    classes, per_launch = forward_classes(k1_prof)
    phase("wan_profile", card=card, provider="auto", step_wall_ms=k1_prof["wall_ms"],
          device_busy_ms=k1_prof["busy_ms"], idle_share=k1_prof["idle_share"], ms_by_class=classes,
          ms_per_launch=per_launch, top_kernels_ms=k1_prof["top_kernels_ms"], device_events=k1_prof["device_events"])
    return sage_launches, auto_launches


_COUNTED = dict(k1=flash_forward, k1_mask=flash_forward_masked_core, prep=flash_qk_prep, k2=flash_bwd_dkdv, k3=flash_bwd_dq, k5=flash_bwd_fused,
                k5_emit=flash_bwd_dq_emit, k6=sage_forward, sage_prep=sage_prep, k7a=flash_forward_twopass,
                k7b=flash_forward_skew, k7c=flash_forward_two_level)


def _counts():
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _zero_counts():
    for fn in _COUNTED.values():
        fn.launches = 0


@contextlib.contextmanager
def switch(name):
    """Set the kernel switch `name` to "1" for the duration (None: no switch)."""
    old = None if name is None else os.environ.get(name)
    if name is not None:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if name is not None:
            if old is None:
                del os.environ[name]
            else:
                os.environ[name] = old


def timed_batches(batch, timed, record):
    """Yield `batch` to `SFTTrainer.train` 1 + `timed` times: after the first
    (warm-up) step, zero the launch counts and reset the peak memory; record
    each later step's seconds (host clock, synced) in record["step_s"], and
    the counts, K2's reduce passes and the peak after the last step, before
    `train` saves."""
    yield batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    reduce_before = flash_bwd_dkdv.reduce_launches
    record["step_s"] = []
    t0 = time.perf_counter()
    for _ in range(timed):
        yield batch
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        record["step_s"].append(t1 - t0)
        t0 = t1
    record["launches"], record["peak_gb"] = _counts(), torch.cuda.max_memory_allocated() / 1e9
    record["reduce"] = flash_bwd_dkdv.reduce_launches - reduce_before


def timed_train_steps(trainer, batch, count):
    """`count` calls of `trainer.train_step` on `batch` (no checkpoint), each
    timed on the host clock up to a sync -> (seconds, launches, peak GB), the
    counts zeroed and the peak reset before the first."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    seconds = []
    for _ in range(count):
        t0 = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds, _counts(), torch.cuda.max_memory_allocated() / 1e9


def step_loss_and_grad(trainer, batch, env=None, provider="auto"):
    """One `forward_backward` with fixed draws under switch `env` and
    `provider` -> (loss, the LoRA gradient flattened in fp32, launches)."""
    trainer.optimizer.zero_grad()
    _zero_counts()
    with switch(env), attention_provider(provider):
        loss, _ = trainer.forward_backward(*batch, generator=torch.Generator("cuda").manual_seed(5))
    grad = torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])
    torch.cuda.synchronize()
    return loss.item(), grad, _counts()


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


class FunctionK4(torch.autograd.Function):
    """K4 as PRs 2-9 glued it: an `autograd.Function` that calls
    `flash_forward` itself, never the op `finetrainers_torch::flash_mha`. A
    yardstick of host cost only."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, rope_cos, rope_sin, scale):
        out, lse = flash_forward(q, k, v, kv_lens, rope_cos, rope_sin, scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, rope_cos, rope_sin)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens, rope_cos, rope_sin = ctx.saved_tensors
        return (*flash_backward(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, ctx.scale),
                None, None, None, None)


class CustomOpK4:
    """K4 as a `torch.library.custom_op` with `register_autograd` over the
    same forward and backward, the design the dispatcher op inside an
    `autograd.Function` replaced. A yardstick of its host cost only."""

    _op = None

    @classmethod
    def apply(cls, q, k, v, kv_lens, rope_cos, rope_sin, scale):
        if cls._op is None:
            cls._op = _register_custom_op_k4()
        return cls._op(q, k, v, kv_lens, rope_cos, rope_sin, scale)[0]


def _register_custom_op_k4():
    name = "finetrainers_smoke::flash_mha_custom_op"

    @torch.library.custom_op(name, mutates_args=())
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: Optional[torch.Tensor],
           rope_cos: Optional[torch.Tensor], rope_sin: Optional[torch.Tensor],
           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
        return flash_forward(q, k, v, kv_lens, rope_cos, rope_sin, scale)

    def setup_context(ctx, inputs, output):
        q, k, v, kv_lens, rope_cos, rope_sin, scale = inputs
        ctx.save_for_backward(q, k, v, *output, kv_lens, rope_cos, rope_sin)
        ctx.scale = scale
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)

    def backward(ctx, do, _dlse):
        q, k, v, out, lse, kv_lens, rope_cos, rope_sin = ctx.saved_tensors
        return (*flash_backward(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, ctx.scale),
                None, None, None, None)

    torch.library.register_autograd(name, backward, setup_context=setup_context)
    return op


K4_GLUES = ("op", "function", "custom_op")


def k4_host_cost(trainer, batch, rounds, calls=50):
    """K4's glue, interleaved: the port's `FlashAttentionFunction` (outside a
    dispatch mode, as here, it calls `flash_forward` itself), `FunctionK4` and
    `CustomOpK4`, all over the same kernels. Each of `rounds` rounds times one
    train step, then `calls` host-bound forward and backward calls at LTX's
    cross-attention shape (1, 32, 2688, 128, 64; kv_lens [37]; kernels of
    tens of µs, so the host's issue time sets it), under each glue in an
    order that rotates by one every round, so the host's drift reaches every
    glue alike. Returns {glue: step seconds}, {glue: µs a call}."""
    flash_ops = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")
    port = flash_ops.FlashAttentionFunction
    glues = {"op": port, "function": FunctionK4, "custom_op": CustomOpK4}
    g = torch.Generator("cuda").manual_seed(21)
    q = torch.randn(1, 2688, 32, 64, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn(1, CAPTION_LEN, 32, 64, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    do = torch.randn(1, 2688, 32, 64, generator=g, device="cuda").to(torch.bfloat16)
    lens = torch.tensor([CAPTION_VALID], dtype=torch.int32, device="cuda")

    def call_us():
        flash_ops.flash_attention(q, k, v, kv_lens=lens).backward(do)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            flash_ops.flash_attention(q, k, v, kv_lens=lens).backward(do)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    seconds, micros = {glue: [] for glue in K4_GLUES}, {glue: [] for glue in K4_GLUES}
    try:
        for glue in K4_GLUES:  # one warm-up step and call each
            flash_ops.FlashAttentionFunction = glues[glue]
            timed_train_steps(trainer, batch, 1)
            call_us()
        for r in range(rounds):
            for glue in K4_GLUES[r % 3:] + K4_GLUES[:r % 3]:
                flash_ops.FlashAttentionFunction = glues[glue]
                seconds[glue] += timed_train_steps(trainer, batch, 1)[0]
                micros[glue].append(call_us())
    finally:
        flash_ops.FlashAttentionFunction = port
    return seconds, micros


def train_batch():
    """Seeded VAE moments of one 49x512x768 clip and seeded caption states with a padded mask."""
    g = torch.Generator("cuda").manual_seed(11)
    moments = torch.randn(MOMENTS_SHAPE, generator=g, device="cuda")
    moments[:, MOMENTS_SHAPE[1] // 2:] = 0.5 * moments[:, MOMENTS_SHAPE[1] // 2:] - 2.0  # log-variance
    channels = MOMENTS_SHAPE[1] // 2
    conditions = {
        "encoder_hidden_states": torch.randn(1, CAPTION_LEN, 4096, generator=g, device="cuda").to(torch.bfloat16),
        "encoder_attention_mask": (torch.arange(CAPTION_LEN, device="cuda") < CAPTION_VALID).to(torch.int32)[None],
    }
    latents = {"latents": moments, "latents_mean": torch.zeros(channels, device="cuda"),
               "latents_std": torch.ones(channels, device="cuda")}
    return conditions, latents


def train(card):
    """The training path; returns the kernels' launches there."""
    t0 = time.perf_counter()
    args = BaseArgs(training_type="lora", rank=TRAIN_RANK, lora_alpha=TRAIN_RANK, seed=0,
                    train_steps=1 + TRAIN_TIMED_STEPS, output_dir=str(SMOKE_DIR / "ltx_train"))
    spec = get_model_specification_cls("ltx_video", "lora")(device=torch.device("cuda"), seed=0)
    trainer = SFTTrainer(args, spec)
    trainer.prepare()
    module = trainer.transformer.module
    torch.cuda.synchronize()
    frozen = [p for n, p in module.named_parameters() if n not in trainer._trainable]
    base_params = sum(p.numel() for p in frozen)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    phase("train_load", seconds=time.perf_counter() - t0, base_params=base_params, lora_params=lora_params,
          layers=len(module.transformer_blocks), rank=TRAIN_RANK, lora_alpha=TRAIN_RANK)
    if base_params != BASE_PARAMS or len(module.transformer_blocks) != NUM_LAYERS:
        raise AssertionError("the trainer did not build the published LTX-Video width and depth")

    def frozen_checksum():
        return torch.stack([torch.stack([p.float().sum(), p.float().abs().sum()]) for p in frozen]).double().sum(0)

    frozen_before = frozen_checksum()
    lora_before = {n: p.detach().clone() for n, p in trainer._trainable.items()}
    batch = train_batch()

    record = {}
    trainer.train(timed_batches(batch, TRAIN_TIMED_STEPS, record))  # a warm-up step, the timed ones, the final save
    step_s, launches, peak_gb = record["step_s"], record["launches"], record["peak_gb"]
    saved = trainer.checkpointer.all_steps()
    losses = trainer.state.train_state.global_avg_losses
    finite = all(np.isfinite(losses))
    moved = all(not torch.equal(p, lora_before[n]) for n, p in trainer._trainable.items())
    frozen_same = bool(torch.equal(frozen_checksum(), frozen_before))
    expected = 2 * NUM_LAYERS * TRAIN_TIMED_STEPS  # K1, K2, K3; the pre-pass runs before K1 and before K2/K3
    flops = ltx_train_step_flops(spec.transformer_config, TRAIN_RANK, 0.0, B=1, S=2688, L_CTX=CAPTION_LEN)
    median_s = statistics.median(step_s)
    phase("train", card=card, steps=trainer.state.train_state.step, timed_steps=TRAIN_TIMED_STEPS,
          step_seconds=step_s, median_step_s=median_s, losses=losses, losses_finite=finite,
          lora_factors_moved=moved, frozen_weights_unchanged=frozen_same, launches=launches,
          launches_expected_each=expected, prep_launches_expected=2 * expected, max_memory_allocated_gb=peak_gb,
          model_flops_per_step=flops,
          model_tflops=flops / median_s / 1e12, bf16_peak_tflops=PEAK_BF16_FLOPS / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, checkpoints_saved=saved)
    if not (finite and moved and frozen_same and saved == [1 + TRAIN_TIMED_STEPS]
            and launches == {k_: {"k1": expected, "prep": 2 * expected, "k2": expected, "k3": expected}.get(k_, 0)
                             for k_ in launches}):
        raise AssertionError("training check failed")

    # K4's host cost in this host-bound step: the op against an autograd.Function around the same kernels
    # (2 rounds, cut from 12, then from 3, to make room for later phases).
    k4_s, k4_us = k4_host_cost(trainer, batch, rounds=2)
    phase("train_k4_host_cost", card=card, order="interleaved, rotating by one each round",
          step_seconds=k4_s, median_step_s={glue: statistics.median(k4_s[glue]) for glue in K4_GLUES},
          call_us=k4_us, median_call_us={glue: statistics.median(k4_us[glue]) for glue in K4_GLUES},
          call_shape="LTX cross-attention (1, 32, 2688, 128, 64), kv_lens [37], forward and backward")

    # One step's loss and LoRA gradient with the kernels against plain fp32
    # attention, both under per-block full remat (plain attention keeps fp32
    # (1, 32, 2688, 2688) scores per layer; remat frees them block by block).
    module.gradient_checkpointing = "full"

    def loss_and_grad(provider):
        trainer.optimizer.zero_grad()
        with attention_provider(provider):
            loss, _ = trainer.forward_backward(*batch, generator=torch.Generator("cuda").manual_seed(5))
        return loss.item(), torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])

    _zero_counts()
    kernel_loss, kernel_grad = loss_and_grad("auto")
    torch.cuda.synchronize()
    remat_launches = _counts()
    plain_loss, plain_grad = loss_and_grad("_native_math")
    trainer.optimizer.zero_grad()
    module.gradient_checkpointing = None
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    grad_rel_l2 = ((kernel_grad - plain_grad).norm() / plain_grad.norm()).item()
    grad_finite = bool(torch.isfinite(kernel_grad).all())
    del kernel_grad, plain_grad
    phase("train_step_vs_plain_attention", remat="full", kernel_loss=kernel_loss, plain_loss=plain_loss,
          loss_rel_diff=loss_rel, loss_bound=TRAIN_LOSS_REL_TOL, grad_rel_l2=grad_rel_l2,
          grad_bound=STEP_REL_L2_TOL, grad_finite=grad_finite, launches=remat_launches,
          k1_launches_expected=4 * NUM_LAYERS, k2_k3_launches_expected=2 * NUM_LAYERS,
          prep_launches_expected=6 * NUM_LAYERS)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel_l2 <= STEP_REL_L2_TOL and grad_finite
            and remat_launches["k1"] == 4 * NUM_LAYERS and remat_launches["prep"] == 6 * NUM_LAYERS
            and remat_launches["k2"] == remat_launches["k3"] == 2 * NUM_LAYERS):
        raise AssertionError("a train step with the kernels differs from the one with plain attention")

    host = host_split(trainer, batch)

    prof = profile_device(lambda: trainer.train_step(*batch))
    k1_self, k1_cross = _split(prof["launches"]["k1"], by_order=True)
    per_launch = {"k1": {"self_attention": _median(k1_self), "cross_attention": _median(k1_cross)}}
    for cls in ("k2", "k3", "prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=False)
        per_launch[cls] = {"self_attention": _median(self_ms), "cross_attention": _median(cross_ms)}
    per_launch["k2_reduce"] = {"cross_attention": _median(prof["launches"]["k2_reduce"])}  # split q loops only
    classes = dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()})
    phase("train_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, host_seconds=host,
          launches={cls: len(v) for cls, v in prof["launches"].items()}, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return launches


def wan_train_batch(moments_shape, seed=12):
    """Seeded VAE moments of one clip (identity latent statistics, 16 channels)
    and seeded caption states with all 512 tokens valid."""
    g = torch.Generator("cuda").manual_seed(seed)
    moments = torch.randn(moments_shape, generator=g, device="cuda")
    channels = moments_shape[1] // 2
    moments[:, channels:] = 0.5 * moments[:, channels:] - 2.0  # log-variance
    conditions = {
        "encoder_hidden_states": torch.randn(1, WAN_CAPTION_LEN, 4096, generator=g, device="cuda").to(torch.bfloat16),
        "encoder_attention_mask": torch.ones(1, WAN_CAPTION_LEN, dtype=torch.int32, device="cuda"),
    }
    latents = {"latents": moments, "latents_mean": torch.zeros(channels, device="cuda"),
               "latents_std": torch.ones(channels, device="cuda")}
    return conditions, latents


def wan_block_flops(cfg: dict, lora_rank: int, S: int, L_CTX: int) -> dict:
    """Matmul FLOPs of one Wan block's forward by kind (the terms of
    tools/floor_bench.py's `setup_wan` `flops`, with its shape constants as arguments)."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    return dict(
        projections=4 * 2 * S * d * d + 2 * 2 * L_CTX * d * d,  # q, k, v, out of self-attention, q, out and k, v
        attention=2 * 2 * S * S * d + 2 * 2 * S * L_CTX * d,  # self- and cross-attention scores and values
        ff1=2 * S * d * cfg["ffn_dim"],  # the MLP's first product, ffn_dim (8960) wide
        ff2=2 * S * d * cfg["ffn_dim"],
        lora=8 * 2 * S * (d * lora_rank + lora_rank * d),
    )


def wan_train_step_flops(cfg: dict, lora_rank: int, remat_factor: float, B: int, S: int, L_CTX: int) -> float:
    """Analytic matmul FLOPs of one Wan LoRA train step (copied from
    tools/floor_bench.py's `setup_wan` `flops`): the forward, about as much
    again for the backward, and `remat_factor` of the forward recomputed."""
    return cfg["num_layers"] * sum(wan_block_flops(cfg, lora_rank, S, L_CTX).values()) * B * (2.0 + remat_factor)


def wan_remat_factor(cfg: dict, lora_rank: int, S: int, L_CTX: int, policy: str) -> float:
    """The share of the forward's matmul FLOPs that `policy` recomputes: all of
    it under "full", none under "ops" (K4 and every product saved), all but
    attention under "ops_attn", the MLP's first product under "ops_narrow"
    (the only product over 4096 wide but its LoRA B, counted in "lora")."""
    terms = wan_block_flops(cfg, lora_rank, S, L_CTX)
    total = sum(terms.values())
    return {"full": total, "ops": 0.0, "ops_attn": total - terms["attention"], "ops_narrow": terms["ff1"]}[policy] / total


def wan_train(card):
    """The Wan 2.1 T2V-1.3B LoRA training path at full width: the timed steps
    (K1, pre-pass, K2, K3), the same step under the fused-backward switch (K5)
    and under each forward switch (K7a/b/c), a step against plain attention at
    4992 tokens and a profile. Returns the launches of each path."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0)
    trainer = SFTTrainer(BaseArgs(**WAN_TRAIN_ARGS, output_dir=str(SMOKE_DIR / "wan_train")), spec)
    trainer.prepare()
    module = trainer.transformer.module
    torch.cuda.synchronize()
    frozen = [p for n, p in module.named_parameters() if n not in trainer._trainable]
    base_params = sum(p.numel() for p in frozen)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    phase("wan_train_load", seconds=time.perf_counter() - t0, base_params=base_params, lora_params=lora_params,
          layers=len(module.blocks), remat=module.gradient_checkpointing,
          **{k_: v for k_, v in WAN_TRAIN_ARGS.items() if k_ not in ("training_type", "seed", "train_steps")})
    if (base_params != WAN_PARAMS or len(module.blocks) != WAN_LAYERS or module.gradient_checkpointing != "full"
            or trainer.scheduler.shift != 3.0):
        raise AssertionError("the trainer did not build the published Wan 2.1 T2V-1.3B width and depth under remat")

    def frozen_checksum():
        return torch.stack([torch.stack([p.float().sum(), p.float().abs().sum()]) for p in frozen]).double().sum(0)

    frozen_before = frozen_checksum()
    lora_before = {n: p.detach().clone() for n, p in trainer._trainable.items()}
    batch = wan_train_batch(WAN_MOMENTS)

    record = {}
    trainer.train(timed_batches(batch, WAN_TRAIN_TIMED_STEPS, record))  # a warm-up step, the timed ones, a save
    step_s, launches, peak_gb = record["step_s"], record["launches"], record["peak_gb"]
    saved = trainer.checkpointer.all_steps()
    losses = trainer.state.train_state.global_avg_losses
    finite = all(np.isfinite(losses))
    moved = all(not torch.equal(p, lora_before[n]) for n, p in trainer._trainable.items())
    frozen_same = bool(torch.equal(frozen_checksum(), frozen_before))
    del lora_before
    # The pre-pass runs before each of K1's 4*30 launches (forward and recompute) and each of the 2*30 backwards.
    per_step = dict(k1=4 * WAN_LAYERS, prep=6 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
    expected = {k_: per_step.get(k_, 0) * WAN_TRAIN_TIMED_STEPS for k_ in launches}
    flops = wan_train_step_flops(spec.transformer_config, WAN_TRAIN_RANK, 1.0, B=1, S=WAN_TOKENS,
                                 L_CTX=WAN_CAPTION_LEN)
    median_s = statistics.median(step_s)
    phase("wan_train", card=card, steps=trainer.state.train_state.step, timed_steps=WAN_TRAIN_TIMED_STEPS,
          tokens=WAN_TOKENS, text_tokens=WAN_CAPTION_LEN, step_seconds=step_s, median_step_s=median_s, losses=losses,
          losses_finite=finite, lora_factors_moved=moved, frozen_weights_unchanged=frozen_same, launches=launches,
          launches_expected=expected, max_memory_allocated_gb=peak_gb, model_flops_per_step=flops,
          model_tflops=flops / median_s / 1e12, bf16_peak_tflops=PEAK_BF16_FLOPS / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, checkpoints_saved=saved)
    if not (finite and moved and frozen_same and launches == expected and saved == [1 + WAN_TRAIN_TIMED_STEPS]):
        raise AssertionError("Wan training check failed")
    paths = {"wan_train": launches}

    # K5: the same step under the fused-backward switch.
    split_loss, split_grad, split_launches = step_loss_and_grad(trainer, batch)
    fused_loss, fused_grad, fused_launches = step_loss_and_grad(trainer, batch, "FINETRAINERS_FLASH_FUSED_BWD")
    fused_rel = rel_l2(fused_grad, split_grad)
    del fused_grad

    # K7a/b/c: one forward_backward under each forward switch, against the K1 step above, at the
    # same weights (before the fused-backward timed steps update them). K7a and K7c run the pre-pass
    # first, as K1 does; K7b (cross-attention only: the self-attention calls carry tables and stay on
    # K1) does not.
    for env, key, expected_k1, count in (("FINETRAINERS_FLASH_TWOPASS", "k7a", 0, 4 * WAN_LAYERS),
                                          ("FINETRAINERS_FLASH_SKEW", "k7b", 2 * WAN_LAYERS, 2 * WAN_LAYERS),
                                          ("FINETRAINERS_FLASH_TWOLEVEL", "k7c", 0, 4 * WAN_LAYERS)):
        loss, grad, variant_launches = step_loss_and_grad(trainer, batch, env)
        loss_rel, grad_rel = abs(loss - split_loss) / abs(split_loss), rel_l2(grad, split_grad)
        del grad
        forwards_with_prep = 4 * WAN_LAYERS if key != "k7b" else expected_k1
        want = dict(k1=expected_k1, prep=forwards_with_prep + 2 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS,
                    **{key: count})
        want = {k_: want.get(k_, 0) for k_ in variant_launches}
        phase("wan_train_fwd_variants", card=card, switch=env, kernel=key, loss=loss, k1_loss=split_loss,
              loss_rel_diff=loss_rel, loss_bound=VARIANT_LOSS_REL_TOL, lora_grad_rel_l2=grad_rel,
              grad_bound=VARIANT_GRAD_REL_L2_TOL, launches=variant_launches, launches_expected=want)
        if not (loss_rel <= VARIANT_LOSS_REL_TOL and grad_rel <= VARIANT_GRAD_REL_L2_TOL and variant_launches == want):
            raise AssertionError(f"the Wan step under {env} failed its checks")
        paths[f"wan_train_{key}"] = variant_launches
    del split_grad

    with switch("FINETRAINERS_FLASH_FUSED_BWD"):
        fused_step_s, fused_timed_launches, fused_peak_gb = timed_train_steps(trainer, batch, WAN_SWITCH_TIMED_STEPS)
    fused_expected = dict(k1=4 * WAN_LAYERS, prep=6 * WAN_LAYERS, k5=2 * WAN_LAYERS, k5_emit=2 * WAN_LAYERS)
    fused_expected = {k_: fused_expected.get(k_, 0) for k_ in fused_launches}
    phase("wan_train_fused_bwd", card=card, split_loss=split_loss, fused_loss=fused_loss,
          loss_bit_equal=fused_loss == split_loss, lora_grad_rel_l2=fused_rel, grad_bound=FUSED_GRAD_REL_L2_TOL,
          launches=fused_launches, launches_expected=fused_expected, split_launches=split_launches,
          step_seconds=fused_step_s, median_step_s=statistics.median(fused_step_s),
          split_median_step_s=median_s, max_memory_allocated_gb=fused_peak_gb)
    if not (fused_loss == split_loss and fused_rel <= FUSED_GRAD_REL_L2_TOL and fused_launches == fused_expected
            and all(v == fused_expected[k_] * WAN_SWITCH_TIMED_STEPS for k_, v in fused_timed_launches.items())):
        raise AssertionError("the Wan step under the fused-backward switch failed its checks")
    paths["wan_train_fused_bwd"] = fused_launches

    # K7a, K7c and K7b: timed steps under each forward switch, beside the fused-backward ones above. Per
    # step, K7a and K7c take all 4*30 forwards (self and cross, forward and recompute), each after the
    # pre-pass; K7b takes the 2*30 cross-attention forwards without it, K1 the 2*30 self-attention ones.
    for env, key, per_step_launches in (
            ("FINETRAINERS_FLASH_TWOPASS", "k7a", dict(k7a=4 * WAN_LAYERS, prep=6 * WAN_LAYERS)),
            ("FINETRAINERS_FLASH_TWOLEVEL", "k7c", dict(k7c=4 * WAN_LAYERS, prep=6 * WAN_LAYERS)),
            ("FINETRAINERS_FLASH_SKEW", "k7b", dict(k7b=2 * WAN_LAYERS, k1=2 * WAN_LAYERS, prep=4 * WAN_LAYERS))):
        with switch(env):
            variant_step_s, variant_launches, variant_peak_gb = timed_train_steps(trainer, batch,
                                                                                  WAN_SWITCH_TIMED_STEPS)
        want = dict(per_step_launches, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
        want = {k_: want.get(k_, 0) * WAN_SWITCH_TIMED_STEPS for k_ in variant_launches}
        phase("wan_train_fwd_variants", card=card, switch=env, kernel=key, timed=True, step_seconds=variant_step_s,
              median_step_s=statistics.median(variant_step_s), split_median_step_s=median_s,
              fused_bwd_median_step_s=statistics.median(fused_step_s), launches=variant_launches,
              launches_expected=want, max_memory_allocated_gb=variant_peak_gb)
        if variant_launches != want:
            raise AssertionError(f"the timed Wan steps under {env} launched other kernels")

    # The kernel step against plain fp32 attention at 4992 tokens (plain scores are 1.2 GB per layer).
    small = wan_train_batch(WAN_SMALL_MOMENTS)
    kernel_loss, kernel_grad, small_launches = step_loss_and_grad(trainer, small)
    plain_loss, plain_grad, _ = step_loss_and_grad(trainer, small, provider="_native_math")
    trainer.optimizer.zero_grad()
    loss_rel, grad_rel = abs(kernel_loss - plain_loss) / abs(plain_loss), rel_l2(kernel_grad, plain_grad)
    grad_finite = bool(torch.isfinite(kernel_grad).all())
    del kernel_grad, plain_grad, small
    phase("wan_train_step_vs_plain_attention", remat="full", tokens=13 * 16 * 24, kernel_loss=kernel_loss,
          plain_loss=plain_loss, loss_rel_diff=loss_rel, loss_bound=TRAIN_LOSS_REL_TOL, grad_rel_l2=grad_rel,
          grad_bound=STEP_REL_L2_TOL, grad_finite=grad_finite, launches=small_launches)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= STEP_REL_L2_TOL and grad_finite
            and small_launches == {k_: per_step.get(k_, 0) for k_ in small_launches}):
        raise AssertionError("a Wan train step with the kernels differs from the one with plain attention")

    paths.update(wan_train_remat(card, trainer, batch))

    host = host_split(trainer, batch)

    prof = profile_device(lambda: trainer.train_step(*batch))
    per_launch = {}
    for cls in ("k1", "k2", "k3", "prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=False)
        per_launch[cls] = {"self_attention": _median(self_ms), "cross_attention": _median(cross_ms)}
    per_launch["k2_reduce"] = {"cross_attention": _median(prof["launches"]["k2_reduce"])}  # split q loops only
    classes = dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()})
    (reduce_ms, reduce_by), splits = dkdv_reduce_bound(1, 12, WAN_TOKENS, WAN_CAPTION_LEN, 128,
                                                       torch.cuda.get_device_properties(0).multi_processor_count)
    phase("wan_train_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, host_seconds=host,
          k2_reduce_bound=dict(ms=reduce_ms, bound_by=reduce_by, splits=splits),
          launches={cls: len(v) for cls, v in prof["launches"].items()}, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return paths


def wan_train_remat(card, trainer, batch):
    """The Wan step under each remat policy on the trainer of `wan_train`:
    one `forward_backward` per policy at the same weights and draws (loss and
    LoRA gradient against "full", launches), then one warm-up and the timed
    steps per policy (seconds, peak memory, model TFLOP/s with the policy's
    remat factor). Returns each selective policy's launches."""
    module, cfg = trainer.transformer.module, trainer.transformer.config
    per_step = {"full": dict(k1=4 * WAN_LAYERS, prep=6 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)}
    for policy in REMAT_POLICIES[1:]:  # K4 saved: K1 runs in the forward only, the pre-pass before it and each backward
        per_step[policy] = dict(k1=2 * WAN_LAYERS, prep=4 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
    checked = {}
    for policy in REMAT_POLICIES:
        module.gradient_checkpointing = policy
        checked[policy] = step_loss_and_grad(trainer, batch)
    full_loss, full_grad, _ = checked["full"]
    paths, failed = {}, []
    for policy in REMAT_POLICIES:
        module.gradient_checkpointing = policy
        loss, grad, launches = checked[policy]
        # No warm-up step: the checked forward-backward above ran under this policy.
        step_s, timed_launches, peak_gb = timed_train_steps(trainer, batch, WAN_SWITCH_TIMED_STEPS)
        want = {k_: per_step[policy].get(k_, 0) for k_ in launches}
        remat = wan_remat_factor(cfg, WAN_TRAIN_RANK, WAN_TOKENS, WAN_CAPTION_LEN, policy)
        flops = wan_train_step_flops(cfg, WAN_TRAIN_RANK, remat, B=1, S=WAN_TOKENS, L_CTX=WAN_CAPTION_LEN)
        median_s = statistics.median(step_s)
        grad_rel = rel_l2(grad, full_grad)
        phase("wan_train_remat", card=card, policy=policy, loss=loss, full_loss=full_loss,
              loss_bit_equal=loss == full_loss, lora_grad_rel_l2=grad_rel, grad_bound=REMAT_GRAD_REL_L2_TOL,
              launches=launches, launches_expected=want, timed_launches=timed_launches, step_seconds=step_s,
              median_step_s=median_s, max_memory_allocated_gb=peak_gb, remat_factor=remat,
              model_flops_per_step=flops, model_tflops=flops / median_s / 1e12,
              share_of_peak=flops / median_s / PEAK_BF16_FLOPS)
        if not (loss == full_loss and grad_rel <= REMAT_GRAD_REL_L2_TOL and launches == want
                and timed_launches == {k_: v * WAN_SWITCH_TIMED_STEPS for k_, v in want.items()} and peak_gb < 80):
            failed.append(policy)
        if policy != "full":
            paths[f"wan_train_{policy}"] = launches
    # The example's policy's profile is `wan_run`'s (an "ops" step at the example's bucket); this phase's was cut
    # to make room for the control runs.
    module.gradient_checkpointing = "full"
    del checked, full_grad
    if failed:
        raise AssertionError(f"the Wan step under remat {failed} failed its checks")
    return paths


def wan_trainer(output_dir, **args):
    """A fresh full-width Wan LoRA trainer (seeded base weights) with the
    example's optimizer and `args`, checkpointing to `output_dir`."""
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0)
    trainer = SFTTrainer(BaseArgs(**{**WAN_TRAIN_ARGS, **args}, output_dir=str(output_dir)), spec)
    trainer.prepare()
    return trainer


def wan_train_accum_resume(card):
    """Gradient accumulation over 2 micro-steps under "ops" remat, with a
    checkpoint every 2 micro-steps and the 2 newest kept, on 6 seeded batches:
    an unbroken run against a run broken after 3 micro-steps (its final save in
    the middle of an accumulation) and resumed from "latest" by a fresh
    trainer and model. Then the unbroken run's exported adapter, loaded into
    a fresh model, against the resumed model's forward. Returns the
    launches of the unbroken run and the resumed model."""
    batches = [wan_train_batch(WAN_MOMENTS, seed=100 + i) for i in range(ACCUM_MICRO_STEPS)]
    unbroken_dir, broken_dir = SMOKE_DIR / "accum_unbroken", SMOKE_DIR / "accum_broken"

    def snapshot(trainer):
        state = trainer.optimizer.state_dict()
        moments = [(m["exp_avg"], m["exp_avg_sq"]) for m in state["inner"]["inner"]["state"].values()]
        return dict(lora={n: p.detach().clone() for n, p in trainer._trainable.items()}, moments=moments,
                    losses=list(trainer.state.train_state.global_avg_losses), count=trainer.optimizer.count,
                    mini_step=trainer.optimizer.mini_step, saved=trainer.checkpointer.all_steps())

    t0 = time.perf_counter()
    trainer = wan_trainer(unbroken_dir, **ACCUM_ARGS)
    _zero_counts()
    trainer.train(batches)
    torch.cuda.synchronize()
    launches = _counts()
    unbroken, unbroken_s = snapshot(trainer), time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trainer = wan_trainer(broken_dir, **ACCUM_ARGS)
    trainer.train(batches[:ACCUM_BROKEN_AT])
    first = snapshot(trainer)
    del trainer
    torch.cuda.empty_cache()
    trainer = wan_trainer(broken_dir, **ACCUM_ARGS, resume_from_checkpoint="latest")
    resumed_at = (trainer.state.train_state.step, trainer.optimizer.mini_step, trainer.optimizer.count)
    trainer.train(batches[ACCUM_BROKEN_AT:])
    torch.cuda.synchronize()
    resumed, broken_s = snapshot(trainer), time.perf_counter() - t0
    lora_equal = all(torch.equal(p, unbroken["lora"][n]) for n, p in resumed["lora"].items())
    moments_equal = len(resumed["moments"]) == len(unbroken["moments"]) == len(resumed["lora"]) and all(
        torch.equal(a, b) for pair, ref in zip(resumed["moments"], unbroken["moments"]) for a, b in zip(pair, ref))
    want_saved = [ACCUM_MICRO_STEPS - ACCUM_ARGS["checkpointing_steps"], ACCUM_MICRO_STEPS]
    phase("wan_train_accum_resume", card=card, remat="ops", gradient_accumulation_steps=2,
          micro_steps=ACCUM_MICRO_STEPS,
          broken_after=ACCUM_BROKEN_AT, unbroken_seconds=unbroken_s, broken_and_resumed_seconds=broken_s,
          unbroken_checkpoints=unbroken["saved"], broken_checkpoints_before_resume=first["saved"],
          resumed_checkpoints=resumed["saved"], resumed_at=dict(step=resumed_at[0], mini_step=resumed_at[1],
                                                                applied_updates=resumed_at[2]),
          lora_bit_equal=lora_equal, adamw_moments_bit_equal=moments_equal, unbroken_losses=unbroken["losses"],
          resumed_losses=resumed["losses"], applied_updates=[unbroken["count"], resumed["count"]],
          launches=launches)
    if not (lora_equal and moments_equal and resumed["losses"] == unbroken["losses"]
            and unbroken["count"] == resumed["count"] == ACCUM_MICRO_STEPS // 2
            and unbroken["saved"] == resumed["saved"] == want_saved and first["saved"] == [2, ACCUM_BROKEN_AT]
            and resumed_at == (ACCUM_BROKEN_AT, 1, 1) and all(np.isfinite(unbroken["losses"]))
            and launches["k1"] == ACCUM_MICRO_STEPS * 2 * WAN_LAYERS):
        raise AssertionError("the resumed Wan run differs from the unbroken one")
    del unbroken, first, resumed

    # The unbroken run's last export in a fresh model with the same base weights, against the resumed model.
    path = unbroken_dir / "lora_weights" / f"{ACCUM_MICRO_STEPS:06d}" / LORA_WEIGHTS_NAME
    state, config = load_lora_weights(str(path))
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0)
    spec.lora_rank, spec.lora_alpha = WAN_TRAIN_RANK, WAN_TRAIN_RANK
    fresh = spec.load_diffusion_models()["transformer"].module
    apply_lora_state_dict(fresh, state)
    conditions, latents = batches[0]
    inputs = (latents["latents"][:, :16], conditions["encoder_hidden_states"],
              torch.tensor([500.0], device="cuda"), conditions["encoder_attention_mask"])
    with torch.no_grad():
        exported_out = fresh(*inputs)
        trained_out = trainer.transformer.module(*inputs)
    out_equal = torch.equal(exported_out, trained_out)
    phase("wan_lora_export", card=card, file=str(path.relative_to(SMOKE_DIR.parent.parent)),
          bytes=path.stat().st_size, keys=len(state), lora_config=config,
          forward_bit_equal=out_equal, output_shape=list(trained_out.shape))
    if not (out_equal and len(state) == len(trainer._trainable) and torch.isfinite(trained_out).all()
            and config == {"r": WAN_TRAIN_RANK, "lora_alpha": WAN_TRAIN_RANK, "target_modules": BaseArgs.target_modules}):
        raise AssertionError("the exported adapter does not reproduce the trained forward")
    return {"wan_train_accum": launches}


# The Wan example's run through its command line (`python -m finetrainers_tpu_torch.train` with train.sh's flags):
# 2 seeded videos at the example's bucket (precomputed once, so the 4 steps cycle over them), 4 steps (cut from
# 3000) with a checkpoint every 2, the in-loop validation at 4 on the live weights and each run's final validation
# from its export (one request of 2 denoising steps each, cut from 50), against a run broken after 2 steps and
# resumed from "latest".
TRAIN_SH = pathlib.Path(__file__).resolve().parent / "examples" / "training" / "sft" / "wan" / "crush_smol_lora"
WAN_RUN_VIDEOS, WAN_RUN_STEPS, WAN_RUN_BROKEN_AT = 2, 4, 2
WAN_RUN_SINGLE_CARD = ["--parallel_backend", "jax", "--pp_degree", "1", "--dp_degree", "1", "--dp_shards", "1",
                       "--cp_degree", "1", "--tp_degree", "1"]
# A train step at the example's bucket under "ops": K4 saved, so K1 runs in the forward only (30 self, 30 cross),
# the pre-pass before each forward and backward, K2 and K3 in each backward, K2's reduce pass for cross-attention.
WAN_RUN_STEP_LAUNCHES = dict(k1=2 * WAN_LAYERS, prep=4 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
WAN_RUN_REDUCE = WAN_LAYERS
WAN_RUN_PATHS = ("wan_run", "wan_run_resumed")


def train_sh_argv(example=TRAIN_SH, script="train.sh", single_card=WAN_RUN_SINGLE_CARD, **overrides):
    """The flags the `example` directory's `script` passes to its program, its
    `*_cmd` arrays in the order of its command, with the parallel layout
    replaced by `single_card` and each flag of `overrides` set to its value (a
    list for several)."""
    import shlex

    text = (example / script).read_text()
    arrays = {name: shlex.split(" ".join(line.split("#")[0] for line in body.splitlines()))
              for name, body in re.findall(r"^(\w+_cmd)=\(\n(.*?)^\)", text, re.M | re.S)}
    argv = []
    for name in re.findall(r'"\$\{(\w+_cmd)\[@\]\}"', text):
        argv += single_card if name == "parallel_cmd" else arrays[name]
    for flag, value in overrides.items():
        values = [str(v) for v in (value if isinstance(value, list) else [value])]
        if f"--{flag}" in argv:
            i = argv.index(f"--{flag}")
            argv[i + 1:i + 2] = values
        else:
            argv += [f"--{flag}", *values]
    return argv


def wan_run_data(root):
    """WAN_RUN_VIDEOS seeded videos at 49x480x832 (mp4v, as the JAX package's tests write
    them) with captions that start with a common LLM prefix, their
    `metadata.csv`, the example's training.json pointing at them, and the
    example's first validation prompt at 480x832x49 with 2 denoising steps.
    Returns (training.json, validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    frames, height, width = WAN_RUN_BUCKET
    rng = np.random.RandomState(0)
    rows = []
    for i in range(WAN_RUN_VIDEOS):
        writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25, (width, height))
        coarse = (rng.rand(frames, height // 32, width // 32, 3) * 255).astype(np.uint8)
        for frame in coarse:
            writer.write(cv2.resize(frame, (width, height), interpolation=cv2.INTER_LINEAR))
        writer.release()
        rows.append({"file_name": f"clip{i}.mp4", "caption": f"The video shows a hydraulic press crushing object {i}."})
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        w.writerows(rows)
    training = json.loads((TRAIN_SH / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((TRAIN_SH / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2)]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json"


def _jsonl(output_dir):
    """The entries of the run's jsonl tracker log (`<output_dir>/logs/<tracker_name>.jsonl`)."""
    path = next((pathlib.Path(output_dir) / "logs").glob("*.jsonl"))
    return [json.loads(line) for line in path.read_text().splitlines()]


def _lora_and_moments(trainer):
    state = trainer.optimizer.state_dict()["inner"]["state"]
    return ({n: p.detach().clone() for n, p in trainer._trainable.items()},
            [(m["exp_avg"].clone(), m["exp_avg_sq"].clone()) for m in state.values()])


def wan_run(card):
    """The Wan example's run through `finetrainers_tpu_torch.train.main` with
    train.sh's flags (precompute once, "ops" remat, `transformer:ring`,
    slicing and tiling, rank 32, the example's optimizer, bf16) at its own
    49x480x832 bucket (20280 tokens): an unbroken 4-step run against one broken
    after 2 steps and resumed from "latest" (LoRA factors and AdamW moments
    bit-equal, the same sample ids each step). Each step's seconds, launches
    and peak memory, the precompute and validation seconds, one step's
    profile. Returns the launches of the unbroken and the resumed runs."""
    from finetrainers_tpu_torch import train as train_cli

    t0 = time.perf_counter()
    training_json, validation_json = wan_run_data(SMOKE_DIR / "wan_run_data")
    data_s = time.perf_counter() - t0
    unbroken_dir, broken_dir = SMOKE_DIR / "wan_run_unbroken", SMOKE_DIR / "wan_run_broken"

    def argv(output_dir, steps, *extra):
        return train_sh_argv(dataset_config=training_json, validation_dataset_file=validation_json,
                             output_dir=output_dir, report_to="jsonl", train_steps=steps, checkpointing_steps=2,
                             precomputation_items=WAN_RUN_VIDEOS, validation_steps=4) + list(extra)

    steps, validations, profiles = [], [], []
    orig_step, orig_validate = SFTTrainer.train_step, SFTTrainer._validate

    def counted_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        before, reduce_before, t = _counts(), flash_bwd_dkdv.reduce_launches, time.perf_counter()
        if run[0] not in precompute_peaks:  # the peak of the model loads and the precompute before the first step
            precompute_peaks[run[0]] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        out, profiled = [], run[0] == "resumed" and self.state.train_state.step == WAN_RUN_STEPS - 1
        if profiled:  # the last step of the resumed run
            profiles.append(profile_device(lambda: out.append(orig_step(self, *args, **kwargs))))
        else:
            out.append(orig_step(self, *args, **kwargs))
        torch.cuda.synchronize()
        after = _counts()
        steps.append(dict(run=run[0], seconds=time.perf_counter() - t, profiled=profiled,
                          launches={k_: after[k_] - before[k_] for k_ in after}, reduce=flash_bwd_dkdv.reduce_launches - reduce_before,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        return out[0]

    def timed_validate(self, step, final=False):
        torch.cuda.synchronize()
        before, t = _counts(), time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        orig_validate(self, step, final)
        torch.cuda.synchronize()
        after = _counts()
        validations.append(dict(run=run[0], step=step, final=final, seconds=time.perf_counter() - t,
                                launches={k_: after[k_] - before[k_] for k_ in after if after[k_] != before[k_]},
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9))

    run, precompute_peaks, launches = ["unbroken"], {}, {}
    SFTTrainer.train_step, SFTTrainer._validate = counted_step, timed_validate
    try:
        torch.cuda.reset_peak_memory_stats()  # before each run: its model loads and precompute have their own peak
        _zero_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv(unbroken_dir, WAN_RUN_STEPS))
        torch.cuda.synchronize()
        unbroken_s, launches["wan_run"] = time.perf_counter() - t0, _counts()
        unbroken = _lora_and_moments(trainer)
        module = trainer.transformer.module
        shape_ok = (sum(p.numel() for n, p in module.named_parameters() if n not in trainer._trainable) == WAN_PARAMS
                    and len(module.blocks) == WAN_LAYERS and module.gradient_checkpointing == "ops")
        SFTTrainer.train_step = orig_step
        # One batch of the run's precomputed items, then steps under the example's provider and under "auto",
        # in turns.
        spec = trainer.model_specification
        precomputed = unbroken_dir / "precomputed" / PRECOMPUTED_DIR_NAME
        items = [dict(np.load(precomputed / f"{kind}-0.npz")) for kind in ("condition", "latent")]
        batch = to_device((spec.collate_conditions([items[0]]), spec.collate_latents([items[1]])),
                          torch.device("cuda"))
        # No steps under "ring" and "auto" in turns (cut to make room): the run's own steps run "ring".
        latent_shape = list(batch[1]["latents"].shape)
        del trainer, batch, module, spec
        torch.cuda.empty_cache()

        SFTTrainer.train_step = counted_step
        run[0] = "broken"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.main(argv(broken_dir, WAN_RUN_BROKEN_AT))
        torch.cuda.empty_cache()
        run[0] = "resumed"
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        trainer = train_cli.main(argv(broken_dir, WAN_RUN_STEPS, "--resume_from_checkpoint", "latest"))
        torch.cuda.synchronize()
        broken_s, launches["wan_run_resumed"] = time.perf_counter() - t0, _counts()
        resumed = _lora_and_moments(trainer)
        resumed_saved = trainer.checkpointer.all_steps()
        del trainer
        torch.cuda.empty_cache()
    finally:
        SFTTrainer.train_step, SFTTrainer._validate = orig_step, orig_validate

    unbroken_log, broken_log = _jsonl(unbroken_dir), _jsonl(broken_dir)
    ids = [[e["train/sample_ids"] for e in log if "train/sample_ids" in e] for log in (unbroken_log, broken_log)]
    lora_equal = all(torch.equal(p, unbroken[0][n]) for n, p in resumed[0].items())
    moments_equal = len(resumed[1]) == len(unbroken[1]) == len(resumed[0]) and all(
        torch.equal(a, b) for pair, ref in zip(resumed[1], unbroken[1]) for a, b in zip(pair, ref))
    want = {k_: WAN_RUN_STEP_LAUNCHES.get(k_, 0) for k_ in _COUNTED}
    step_launches_ok = all(st["launches"] == want and st["reduce"] == WAN_RUN_REDUCE for st in steps)
    validation_want = 2 * WAN_LAYERS * 2  # self and cross a block, 2 denoising steps, CFG in one batch
    # The unbroken and the resumed runs validate at step 4 in the loop and again from their exports, the broken
    # run only from its export: 5 validations, 2 of them in the loop.
    validations_ok = (all(v["launches"] == {"k1": validation_want, "prep": validation_want} for v in validations)
                      and [(v["run"], v["final"]) for v in validations]
                      == [("unbroken", False), ("unbroken", True), ("broken", True), ("resumed", False),
                          ("resumed", True)])
    timed = [st["seconds"] for st in steps if st["run"] == "unbroken"][1:]
    prof = profiles[0]
    precompute_s = next(e["timing/precompute"] for e in unbroken_log if "timing/precompute" in e)
    phase("wan_run", card=card, entry="python -m finetrainers_tpu_torch.train", argv=argv(unbroken_dir,
          WAN_RUN_STEPS), bucket=list(WAN_RUN_BUCKET), tokens=WAN_RUN_TOKENS, latents_shape=latent_shape,
          published_shape=shape_ok, data_write_s=data_s, precompute_s=precompute_s,
          precompute_s_per_item=precompute_s / WAN_RUN_VIDEOS, load_and_precompute_peak_gb=precompute_peaks,
          step_seconds={r: [st["seconds"] for st in steps if st["run"] == r] for r in ("unbroken", "broken", "resumed")},
          median_step_s=statistics.median(timed), step_peak_gb=max(st["peak_gb"] for st in steps),
          step_peaks_gb={r: [st["peak_gb"] for st in steps if st["run"] == r] for r in ("unbroken", "broken", "resumed")},
          step_launches=steps[0]["launches"], step_reduce_passes=steps[0]["reduce"],
          step_launches_all_exact=step_launches_ok,
          profiled_step=dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                             ms_by_class=dict(prof["classes"], **{c: sum(v) for c, v in prof["launches"].items()}),
                             launches={c: len(v) for c, v in prof["launches"].items()}),
          validations=validations, validations_launches_exact=validations_ok,
          unbroken_run_s=unbroken_s, broken_and_resumed_s=broken_s, sample_ids=ids[0],
          resumed_sample_ids=ids[1], lora_bit_equal=lora_equal, adamw_moments_bit_equal=moments_equal,
          resumed_checkpoints=resumed_saved, launches=launches)
    losses = [e["train/global_avg_loss"] for e in unbroken_log if "train/global_avg_loss" in e]
    if not (shape_ok and lora_equal and moments_equal and ids[0] == ids[1] and len(ids[0]) == WAN_RUN_STEPS
            and step_launches_ok and validations_ok and all(np.isfinite(losses)) and len(validations) == 5
            and resumed_saved == [2, 4] and latent_shape == [1, 32, *WAN_RUN_GRID[:1], 60, 104]):
        raise AssertionError("the Wan example's run failed its checks")
    return launches


# Wan 2.1 I2V-14B at full width: LoRA training at the example's bucket, then image-to-video serving through the
# port's inference runner at 81x480x832 with the exported adapter and UniPC, then the image-KV branch.


def _free_cuda():
    """Drop what a finished phase left to the collector and return the card's cache."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def i2v_train_batch(seed=40):
    """`wan_train_batch` at the example's bucket, with seeded condition moments
    and the first-frame mask (1, 4, 13, 60, 104) that `prepare_latents` gives
    an I2V clip."""
    conditions, latents = wan_train_batch(I2V_TRAIN_MOMENTS, seed=seed)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    cond = torch.randn(I2V_TRAIN_MOMENTS, generator=g, device="cuda")
    channels = I2V_TRAIN_MOMENTS[1] // 2
    cond[:, channels:] = 0.5 * cond[:, channels:] - 2.0
    mask = torch.zeros((1, 4, *I2V_TRAIN_MOMENTS[2:]), device="cuda")
    mask[:, :, 0] = 1.0
    latents.update(latent_condition=cond, latent_condition_mask=mask)
    return conditions, latents


def _third_split(ms_list):
    """Per-block launches in order (self, text cross, image cross) -> the three lists."""
    return ms_list[0::3], ms_list[1::3], ms_list[2::3]


def wan_i2v_train(card):
    """Full-width Wan 2.1 I2V-14B LoRA training (rank 32, the example's
    optimizer, per-block "full" remat) on seeded VAE moments at 49x480x832
    (20280 tokens) with condition latents and 512 valid caption tokens: one
    warm-up and I2V_TRAIN_TIMED_STEPS timed steps through `train`, which then
    saves and exports the adapter; then a profiled step, after which every
    LoRA factor outside the image-KV branch has moved. The image-KV branch does
    not run (the trainer passes no image, as in JAX), so its LoRA B factors
    stay zero. Returns the launches, the adapter's directory and the profile."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0,
                                                        transformer_config=WAN_I2V_14B_CONFIG)
    trainer = SFTTrainer(BaseArgs(**WAN_TRAIN_ARGS, output_dir=str(SMOKE_DIR / "wan_i2v_train")), spec)
    trainer.prepare()
    module = trainer.transformer.module
    torch.cuda.synchronize()
    base_params = sum(p.numel() for n, p in module.named_parameters() if n not in trainer._trainable)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    phase("wan_i2v_train_load", seconds=time.perf_counter() - t0, base_params=base_params, lora_params=lora_params,
          layers=len(module.blocks), remat=module.gradient_checkpointing, config=WAN_I2V_14B_CONFIG,
          memory_allocated_gb=torch.cuda.memory_allocated() / 1e9, card=card)
    if (base_params != I2V_PARAMS or lora_params != I2V_LORA_PARAMS or len(module.blocks) != I2V_LAYERS
            or module.gradient_checkpointing != "full"):
        raise AssertionError("the trainer did not build the published Wan 2.1 I2V-14B width and depth under remat")
    image_branch = [n for n in trainer._trainable if ".add_k_proj." in n or ".add_v_proj." in n]
    lora_before = {n: p.detach().clone() for n, p in trainer._trainable.items() if n not in image_branch}
    batch = i2v_train_batch()

    record = {}
    trainer.train(timed_batches(batch, I2V_TRAIN_TIMED_STEPS, record))  # a warm-up step, the timed ones, a save
    step_s, launches, peak_gb = record["step_s"], record["launches"], record["peak_gb"]
    losses = trainer.state.train_state.global_avg_losses
    finite = all(np.isfinite(losses))
    prof = profile_device(lambda: trainer.train_step(*batch))  # the third step
    moved = all(not torch.equal(trainer._trainable[n], p) for n, p in lora_before.items())
    image_b_zero = all(not trainer._trainable[n].any() for n in image_branch if n.endswith("lora_B.weight"))
    del lora_before
    per_step = dict(k1=4 * I2V_LAYERS, prep=6 * I2V_LAYERS, k2=2 * I2V_LAYERS, k3=2 * I2V_LAYERS)
    expected = {k_: per_step.get(k_, 0) * I2V_TRAIN_TIMED_STEPS for k_ in launches}
    # No reduce pass: K2 splits its q loop only where a call's kv-tile CTAs are fewer than the H100's 132 SMs, and
    # the text cross-attention here has 40 heads x 4 tiles of 128 keys = 160 (T2V-1.3B's has 12 x 4 = 48).
    expected_reduce = 0
    adapter = SMOKE_DIR / "wan_i2v_train" / "lora_weights" / f"{1 + I2V_TRAIN_TIMED_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    flops = wan_train_step_flops(spec.transformer_config, WAN_TRAIN_RANK, 1.0, B=1, S=WAN_RUN_TOKENS,
                                 L_CTX=WAN_CAPTION_LEN)
    median_s = statistics.median(step_s)
    phase("wan_i2v_train", card=card, steps=trainer.state.train_state.step, timed_steps=I2V_TRAIN_TIMED_STEPS,
          tokens=WAN_RUN_TOKENS, text_tokens=WAN_CAPTION_LEN, step_seconds=step_s, median_step_s=median_s,
          losses=losses, losses_finite=finite, lora_factors_moved=moved, image_branch_lora_b_zero=image_b_zero,
          launches=launches, launches_expected=expected, k2_reduce_launches=record["reduce"],
          k2_reduce_expected=expected_reduce, max_memory_allocated_gb=peak_gb, model_flops_per_step=flops,
          model_tflops=flops / median_s / 1e12, share_of_peak=flops / median_s / PEAK_BF16_FLOPS,
          export=str(adapter.relative_to(SMOKE_DIR.parent.parent)), export_keys=len(state),
          export_bytes=(adapter / LORA_WEIGHTS_NAME).stat().st_size, export_lora_config=config)
    if not (finite and moved and image_b_zero and launches == expected and record["reduce"] == expected_reduce
            and len(state) == len(trainer._trainable) and config.get("r") == WAN_TRAIN_RANK):
        raise AssertionError("Wan I2V training check failed")
    del state

    k2_self, k2_cross = _split(prof["launches"]["k2"], by_order=False)
    k3_self, k3_cross = _split(prof["launches"]["k3"], by_order=False)
    k1_self, k1_cross = _split(prof["launches"]["k1"], by_order=False)
    in_step = dict(k1_self=_median(k1_self), k1_cross=_median(k1_cross), k2_self=_median(k2_self),
                   k2_cross=_median(k2_cross), k3_self=_median(k3_self), k3_cross=_median(k3_cross),
                   prep=_median(prof["launches"]["prep"]), k2_reduce=_median(prof["launches"]["k2_reduce"]))
    classes = dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()})
    phase("wan_i2v_train_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, ms_per_launch=in_step,
          launches={cls: len(v) for cls, v in prof["launches"].items()}, top_kernels_ms=prof["top_kernels_ms"],
          device_events=prof["device_events"])
    del trainer, module, batch, spec
    phase("wan_i2v_train_freed", memory_allocated_gb=_free_cuda())
    return dict(launches=launches, reduce=record["reduce"], adapter=adapter, in_step=in_step)


def i2v_first_frame():
    """A seeded 480x832 RGB first frame written as PNG with cv2 (smooth colour
    blobs, so the VAE sees structure), and its path."""
    import cv2

    path = SMOKE_DIR / "i2v_first_frame.png"
    coarse = (np.random.RandomState(3).rand(480 // 32, 832 // 32, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(path), cv2.resize(coarse, (832, 480), interpolation=cv2.INTER_LINEAR))
    return path


def i2v_checkpoint_dir():
    """A model directory that holds only `scheduler/scheduler_config.json`, as
    the public I2V-14B-480P checkpoint names its scheduler."""
    root = SMOKE_DIR / "wan_i2v_checkpoint"
    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(I2V_SCHEDULER_CONFIG))
    return root


def wan_i2v_serve(card, adapter):
    """One image-to-video request at 81x480x832 through the port's runner,
    `inference.main`, with CFG 5.0 and 2 UniPC steps read from the scheduler
    config, the adapter `wan_i2v_train` exported, and a first frame from a PNG.
    The VAE's encode and decode, each denoise step and the request are timed
    by wrappers (synced); the video must be finite, (81, 480, 832, 3), the
    scheduler UniPC and the transformer's LoRA factors the adapter's. K1 and the
    pre-pass run 80 times a step: the image branch is not wired, as in JAX."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.models.autoencoders import AutoencoderKL3D
    from finetrainers_tpu_torch.models.wan.pipeline import WanPipeline

    import cv2

    image_path, root, out_dir = i2v_first_frame(), i2v_checkpoint_dir(), SMOKE_DIR / "wan_i2v_serve"
    argv = ["--model_name", "wan", "--pretrained_model_name_or_path", str(root), "--inference_type",
            "image_to_video", "--image_path", str(image_path), "--prompt", PROMPTS[0], "--height", "480", "--width",
            "832", "--num_frames", "81", "--num_inference_steps", str(I2V_STEPS), "--guidance_scale", "5.0",
            "--lora_weights", str(adapter), "--output_dir", str(out_dir), "--seed", "0"]
    adapter_state, _ = load_lora_weights(str(adapter))
    probe_key = "transformer.blocks.0.attn1.to_q.lora_B.weight"
    probe = adapter_state[probe_key]
    del adapter_state
    seconds, facts = {"encode": [], "decode": [], "step": [], "request": []}, {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    originals = {name: getattr(cls, name) for cls, name in ((AutoencoderKL3D, "encode"), (AutoencoderKL3D, "decode"),
                                                            (WanPipeline, "denoise_step"), (WanPipeline, "__call__"))}
    request = timed("request", originals["__call__"])

    def call(self, *args, **kwargs):
        facts["scheduler"] = type(self.scheduler).__name__
        facts["image_encoder_wired"] = self.image_encoder is not None
        lora_b = dict(self.transformer.module.named_parameters())[probe_key[len("transformer."):]]
        facts["lora_loaded"] = bool(torch.equal(lora_b.detach().cpu(), probe.to(lora_b.dtype)))
        facts["lora_scaling"] = self.transformer.module.blocks[0].attn1.to_q.scaling
        video = request(self, *args, **kwargs)
        facts["video_shape"], facts["video_dtype"] = list(video.shape), str(video.dtype)
        return video

    AutoencoderKL3D.encode = timed("encode", originals["encode"])
    AutoencoderKL3D.decode = timed("decode", originals["decode"])
    WanPipeline.denoise_step = timed("step", originals["denoise_step"])
    WanPipeline.__call__ = call
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        paths = inference.main(argv, transformer_config=WAN_I2V_14B_CONFIG)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, peak_gb = _counts(), torch.cuda.max_memory_allocated() / 1e9
    finally:
        for (cls, name) in ((AutoencoderKL3D, "encode"), (AutoencoderKL3D, "decode"), (WanPipeline, "denoise_step"),
                            (WanPipeline, "__call__")):
            setattr(cls, name, originals[name])
    cap = cv2.VideoCapture(paths[0])
    frames_written = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    expected = {k_: 2 * I2V_LAYERS * I2V_STEPS if k_ in ("k1", "prep") else 0 for k_ in launches}
    phase("wan_i2v_serve", card=card, entry="python -m finetrainers_tpu_torch.inference", argv=argv[:-6],
          steps=I2V_STEPS, steps_note="cut from the default 50", tokens=I2V_SERVE_TOKENS, text_tokens=512,
          request_s=seconds["request"], step_s=seconds["step"], vae_encode_s=seconds["encode"],
          vae_decode_s=seconds["decode"], main_wall_s=wall_s, peak_memory_gb=peak_gb, launches=launches,
          launches_expected=expected, written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent))
                                               for p in paths], frames_written=frames_written, **facts)
    if not (facts.get("video_shape") == [81, 480, 832, 3] and facts.get("video_dtype") == "uint8"
            and facts.get("scheduler") == "UniPCFlowScheduler" and facts.get("lora_loaded")
            and not facts.get("image_encoder_wired") and launches == expected and len(seconds["step"]) == I2V_STEPS
            and len(seconds["encode"]) == 1 and len(seconds["decode"]) == 1 and frames_written == 81):
        raise AssertionError("Wan I2V serving through the runner failed its checks")
    phase("wan_i2v_serve_freed", memory_allocated_gb=_free_cuda())
    return launches, seconds


def wan_i2v_image_branch(card):
    """The image-KV branch, as a JAX caller runs it: `WanPipeline` built with
    the spec's image encoder (the offline CLIP-vision stand-in), one denoise
    step at 81x480x832 with CFG over the image embeds, under `auto` (K1 and
    the pre-pass 120 times: self, text and the 257 image keys in each block)
    and under `sage` (the sage pre-pass and K6 120 times), each step counted
    and profiled at once (its seconds are the traced wall time, CUDA events
    around the call). The sage step must fall within K6_STEP_REL_L2_TOL of the
    auto step."""
    from finetrainers_tpu_torch.data.utils import load_image

    t0 = time.perf_counter()
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0,
                                                        transformer_config=WAN_I2V_14B_CONFIG,
                                                        pretrained_model_name_or_path=str(i2v_checkpoint_dir()))
    pipe = spec.load_pipeline()
    pipe = dataclasses.replace(pipe, image_encoder=spec.load_condition_models()["image_encoder"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    image = load_image(str(SMOKE_DIR / "i2v_first_frame.png"), to_float=False)
    with torch.inference_mode():
        ehs, mask, img_embeds = pipe.encode_prompt(PROMPTS[0], None, True, image)
        cond = pipe.image_condition(image, *(I2V_REQUEST[k_] for k_ in ("num_frames", "height", "width")))
        latents = torch.randn(pipe.latent_shape(81, 480, 832), generator=torch.Generator("cuda").manual_seed(9),
                              device="cuda")
        sigma = float(pipe.scheduler.inference_sigmas(50)[1])
        step = lambda: pipe.denoise_step(latents, ehs, mask, 5.0, sigma, img_embeds, cond)  # noqa: E731
        runs = {}
        for provider in ("auto", "sage"):
            with attention_provider(provider):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_counts()
                out = []
                prof = profile_device(lambda: out.append(step()))  # the step counted and profiled at once
                runs[provider] = dict(step_s=prof["wall_ms"] / 1e3, launches=_counts(),
                                      peak_gb=torch.cuda.max_memory_allocated() / 1e9, out=out[0], profile=prof)
    rel = rel_l2(runs["sage"]["out"], runs["auto"]["out"])
    finite = all(bool(torch.isfinite(r["out"]).all()) for r in runs.values())
    per_step = 3 * I2V_LAYERS
    want = {"auto": dict(k1=per_step, prep=per_step), "sage": dict(k6=per_step, sage_prep=per_step)}
    in_step = {}
    for provider, r in runs.items():
        prof = r["profile"]
        if provider == "auto":
            parts = dict(zip(("self", "text", "image"), _third_split(prof["launches"]["k1"])))
            prep = prof["launches"]["prep"]
        else:
            parts = dict(zip(("self", "text", "image"), _third_split(prof["launches"]["k6"])))
            prep = [sum(ms) for ms in zip(*(prof["launches"][cls] for cls in ("sage_prep_sum", "sage_prep_mean",
                                                                              "sage_prep")))]
        kernel = "k1" if provider == "auto" else "k6"
        in_step[provider] = {f"{kernel}_{part}": _median(ms) for part, ms in parts.items()}
        in_step[provider].update({f"prep_{part}": _median(ms) for part, ms in
                                  zip(("self", "text", "image"), _third_split(prep))})
        r["expected"] = {k_: want[provider].get(k_, 0) for k_ in r["launches"]}
        classes = dict(prof["classes"], **{f"{kernel}_{part}": sum(ms) for part, ms in parts.items()})
        phase("wan_i2v_image_branch", card=card, provider=provider, load_s=load_s, step_s=r["step_s"],
              peak_memory_gb=r["peak_gb"], launches=r["launches"], launches_expected=r["expected"],
              image_tokens=int(img_embeds.shape[1]), step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
              idle_share=prof["idle_share"], ms_by_class=classes, ms_per_launch=in_step[provider],
              top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    phase("wan_i2v_image_branch_k6_vs_k1", rel_l2=rel, bound=K6_STEP_REL_L2_TOL, finite=finite,
          shape=list(runs["auto"]["out"].shape))
    if not (rel <= K6_STEP_REL_L2_TOL and finite and img_embeds.shape[1] == I2V_IMAGE_TOKENS
            and all(r["launches"] == r["expected"] for r in runs.values())):
        raise AssertionError("the Wan I2V image branch failed its checks")
    launches = {provider: r["launches"] for provider, r in runs.items()}
    del pipe, spec, runs, ehs, mask, img_embeds, cond, latents, step
    phase("wan_i2v_image_branch_freed", memory_allocated_gb=_free_cuda())
    return launches, in_step


# FLUX.1-dev at full width: its kernels at its shapes, the flux_dev example's run through the command line at its own
# 1280x720 bucket, then a 1024x1024 text-to-image request through the inference runner with the exported adapter.


def flux_tables(latent_h, latent_w):
    """Flux's (1, S, 128) fp32 tables for 512 text tokens (zero ids: identity
    rows) and a latent_h x latent_w latent's packed image tokens, as the model
    builds them."""
    from finetrainers_tpu_torch.models.flux import flux_rope_freqs, prepare_latent_image_ids, rope_tables

    ids = torch.cat([torch.zeros(FLUX_TEXT, 3, device="cuda"),
                     prepare_latent_image_ids(latent_h, latent_w, torch.device("cuda"))])
    return tuple(t[None].contiguous() for t in rope_tables(*flux_rope_freqs(ids, FLUX_AXES)))


def check_flux_kernels(card):
    """K1 and the pre-pass at Flux's serving self-attention (1, 24, 4608, 4608,
    128) and at the example's training shape (1, 24, 4112, 4112, 128, a last
    tile of 16 rows), with the per-token tables, against their plain version
    head by head; then the pre-pass, K2 and K3 at the training shape against
    `flash_backward_reference` head by head. Returns the worst errors and the
    records by case."""
    cases = {"flux_serve_self_tables": (1, FLUX_HEADS, lambda: flux_tables(*FLUX_SERVE_LATENT)),
             "flux_train_self_tables": (1, FLUX_HEADS, lambda: flux_tables(*FLUX_RUN_LATENT))}
    k1_err, k1 = check_k1_wan(card, cases, phase_name="flux_kernel_checks")
    bwd_err, bwd = check_k2k3(card, {"flux_train_self_tables": dict(
        b=1, n=FLUX_HEADS, sq=FLUX_RUN_TOKENS, skv=FLUX_RUN_TOKENS, h=128, lens=None, rope="flux",
        latent=FLUX_RUN_LATENT)}, phase_name="flux_kernel_checks")
    return k1_err, k1, bwd_err, bwd


def joint_train_step_flops(layers: int, d: int, lora_rank: int, remat_factor: float, B: int, S: int) -> float:
    """Analytic matmul FLOPs of one LoRA train step of a joint-stream DiT
    (tools/floor_bench.py's `_attn_ff_flops` with its shape constants as
    arguments): per layer q, k, v, out, the joint scores, the 4x GELU
    feed-forward and six LoRA pairs."""
    per_layer = 4 * 2 * S * d * d + 2 * 2 * S * S * d + 2 * 2 * S * d * 4 * d + 6 * 2 * S * (2 * d * lora_rank)
    return layers * per_layer * B * (2.0 + remat_factor)


def flux_train_step_flops(cfg: dict, lora_rank: int, remat_factor: float, B: int, S: int) -> float:
    """floor_bench's `setup_flux` `flops`: the joint formula, a dual block
    counting twice."""
    return joint_train_step_flops(2 * cfg["num_layers"] + cfg["num_single_layers"],
                                  cfg["num_attention_heads"] * cfg["attention_head_dim"], lora_rank, remat_factor,
                                  B, S)


def flux_run_data(root):
    """4 seeded 1440x810 PNG images (smooth colour blobs, the example's
    portrait aspect, bucketed down to 1280x720 by the data stage) written with
    cv2, their `metadata.csv`, the example's training.json pointing at them,
    and its first validation prompt at 1280x720 with 2 denoising steps.
    Returns (training.json, validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(5)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(FLUX_RUN_IMAGES):
            coarse = (rng.rand(1440 // 90, 810 // 90, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / f"card{i}.png"), cv2.resize(coarse, (810, 1440), interpolation=cv2.INTER_LINEAR))
            w.writerow({"file_name": f"card{i}.png", "caption": f"a trtcrd of the card number {i}, tarot style"})
    training = json.loads((FLUX_EXAMPLE / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((FLUX_EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2)]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json"


def flux_run(card):
    """The flux_dev example's run through `finetrainers_tpu_torch.train.main`
    with its train.sh flags (precompute once, "ops" remat, `transformer:auto`,
    slicing and tiling, rank 32, the example's AdamW, logit-normal weighting,
    bf16) on one card, from 4 images on disk at its own 1280x720 bucket (4112
    tokens): 4 steps, then the final validation from the exported adapter in a
    fresh model (one request, 2 steps of 50). Each step's seconds, launches,
    K2 reduce passes and peak memory, model TFLOP/s by floor_bench's formula
    with `ops`' remat factor 0, precompute seconds per item, the validation's
    seconds and launches; after the run, one more step profiled, then steps
    under "ops" and "full" in turns and a profiled "full" step. Returns the
    run's launches, the adapter's directory and the in-step times."""
    from finetrainers_tpu_torch import train as train_cli

    t0 = time.perf_counter()
    training_json, validation_json = flux_run_data(SMOKE_DIR / "flux_run_data")
    data_s = time.perf_counter() - t0
    out_dir = SMOKE_DIR / "flux_run"
    argv = train_sh_argv(FLUX_EXAMPLE, dataset_config=training_json, validation_dataset_file=validation_json,
                         output_dir=out_dir, report_to="jsonl", train_steps=FLUX_RUN_STEPS,
                         precomputation_items=FLUX_RUN_IMAGES)
    with counted_run() as rec:
        trainer = train_cli.main(argv)
    steps, validations, peaks, run_s, launches = (rec[k_] for k_ in ("steps", "validations", "peaks", "run_s",
                                                                      "launches"))
    module = trainer.transformer.module
    base_params = sum(p.numel() for n, p in module.named_parameters() if n not in trainer._trainable)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    shape_ok = (base_params == FLUX_PARAMS and len(module.transformer_blocks) + len(module.single_transformer_blocks)
                == FLUX_LAYERS and module.gradient_checkpointing == "ops"
                and trainer.attn_provider_training == {"transformer": "auto"})
    # After the run and its export: one more step on the run's first precomputed item, profiled.
    spec = trainer.model_specification
    precomputed = out_dir / "precomputed" / PRECOMPUTED_DIR_NAME
    items = [dict(np.load(precomputed / f"{kind}-0.npz")) for kind in ("condition", "latent")]
    latent_shape = list(items[1]["latents"].shape)
    batch = to_device((spec.collate_conditions([items[0]]), spec.collate_latents([items[1]])), torch.device("cuda"))
    prof = profile_device(lambda: trainer.train_step(*batch))
    # The same step under the example's "ops" and under "full", in turns, and a profiled "full" step: how much of
    # the host's time is the selective policy's dispatch mode.
    policy_s, policy_peak = {"ops": [], "full": []}, {}
    for policy in ("full", "ops"):  # one step each, cut from two to make room for the control runs
        module.gradient_checkpointing = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        policy_s[policy].append(time.perf_counter() - t)
        policy_peak[policy] = torch.cuda.max_memory_allocated() / 1e9
    module.gradient_checkpointing = "full"
    full_prof = profile_device(lambda: trainer.train_step(*batch))
    del trainer, module, spec, batch
    _free_cuda()

    log = [json.loads(line) for line in (out_dir / "logs" / "finetrainers-tpu-flux.jsonl").read_text().splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    adapter = out_dir / "lora_weights" / f"{FLUX_RUN_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    images = sorted((out_dir / "validation").rglob("*.png"))
    step_want = dict(k1=FLUX_LAYERS, prep=2 * FLUX_LAYERS, k2=FLUX_LAYERS, k3=FLUX_LAYERS)
    want = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    # No reduce pass: K2 splits its q loop only where a call's kv-tile CTAs are fewer than the H100's 132 SMs, and
    # Flux's joint attention has 24 heads x 33 tiles of 128 keys = 792.
    steps_ok = all(st["launches"] == want and st["reduce"] == 0 for st in steps)
    validation_want = {"k1": 2 * FLUX_LAYERS, "prep": 2 * FLUX_LAYERS}  # 2 denoising steps, no CFG
    validations_ok = (len(validations) == 1 and validations[0]["final"]
                      and validations[0]["launches"] == validation_want)
    timed = [st["seconds"] for st in steps][1:]
    flops = flux_train_step_flops(FLUX_TRANSFORMER_CONFIG, FLUX_RANK, 0.0, B=1, S=FLUX_RUN_TOKENS)
    median_s = statistics.median(timed)
    in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep", "k2", "k3")}
    phase("flux_run", card=card, entry="python -m finetrainers_tpu_torch.train", argv=[str(a) for a in argv],
          bucket=list(FLUX_RUN_BUCKET), tokens=FLUX_RUN_TOKENS, latents_shape=latent_shape,
          published_shape=shape_ok, base_params=base_params, lora_params=lora_params, data_write_s=data_s,
          precompute_s=precompute_s, precompute_s_per_item=precompute_s / FLUX_RUN_IMAGES, peaks_gb=peaks,
          step_seconds=[st["seconds"] for st in steps], median_step_s_2_to_4=median_s,
          step_peaks_gb=[st["peak_gb"] for st in steps], step_launches=steps[0]["launches"],
          step_reduce_passes=[st["reduce"] for st in steps], step_launches_all_exact=steps_ok,
          model_flops_per_step=flops, model_tflops=flops / median_s / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, losses=losses, validations=validations,
          validations_launches_exact=validations_ok, validation_images=[str(i.relative_to(SMOKE_DIR)) for i in images],
          run_s=run_s, launches=launches, export=str(adapter.relative_to(SMOKE_DIR.parent.parent)),
          export_keys=len(state), export_lora_config=config)
    phase("flux_run_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    phase("flux_run_policies", card=card, step_s=policy_s,
          median_step_s={policy: statistics.median(v) for policy, v in policy_s.items()}, peak_gb=policy_peak,
          full_model_tflops=flux_train_step_flops(FLUX_TRANSFORMER_CONFIG, FLUX_RANK, 1.0, B=1, S=FLUX_RUN_TOKENS)
          / statistics.median(policy_s["full"]) / 1e12,
          full_profile=dict(step_wall_ms=full_prof["wall_ms"], device_busy_ms=full_prof["busy_ms"],
                            idle_share=full_prof["idle_share"],
                            ms_by_class=dict(full_prof["classes"], **{cls: sum(v) for cls, v in
                                                                      full_prof["launches"].items()}),
                            launches={cls: len(v) for cls, v in full_prof["launches"].items()}))
    if not (shape_ok and steps_ok and validations_ok and len(steps) == FLUX_RUN_STEPS and all(np.isfinite(losses))
            and len(losses) == FLUX_RUN_STEPS and len(state) == 2 * (19 * 12 + 38 * 5) and config.get("r") == FLUX_RANK
            and latent_shape == [1, 32, *FLUX_RUN_LATENT] and len(images) == 1):
        raise AssertionError("the flux_dev example's run failed its checks")
    del state
    return dict(launches=launches, adapter=adapter, in_step=in_step)


def flux_checkpoint_dir():
    """A model directory that holds only `scheduler/scheduler_config.json`, as the
    public FLUX.1-dev checkpoint names its scheduler."""
    root = SMOKE_DIR / "flux_checkpoint"
    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(FLUX_SCHEDULER_CONFIG))
    return root


def flux_serve(card, adapter):
    """One 1024x1024 text-to-image request of full-width FLUX.1-dev through the
    port's runner, `inference.main`, with guidance 3.5 embedded, 4 flow-match
    Euler steps of 28 with dynamic shifting read from the scheduler config,
    and the adapter `flux_run` exported. The VAE decode, each denoise step and
    the request are timed by synced wrappers; the image must be finite, (1024,
    1024, 3) uint8, the served model's LoRA factors the adapter's, K1 and the
    pre-pass 57 times a step and no other kernel, and the VAE unsplit (its
    largest activation under SPLIT_ELEMENTS). Then one denoise step profiled."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.models import autoencoders
    from finetrainers_tpu_torch.models.autoencoders import AutoencoderKL3D
    from finetrainers_tpu_torch.models.flux import FluxPipeline

    import cv2

    out_dir = SMOKE_DIR / "flux_serve"
    argv = ["--model_name", "flux", "--pretrained_model_name_or_path", str(flux_checkpoint_dir()),
            "--inference_type", "text_to_image", "--prompt", "a trtcrd of a fox holding a lantern, tarot style",
            "--height", "1024", "--width", "1024", "--num_inference_steps", str(FLUX_SERVE_STEPS),
            "--guidance_scale", "3.5", "--lora_weights", str(adapter), "--output_dir", str(out_dir), "--seed", "0"]
    adapter_state, _ = load_lora_weights(str(adapter))
    probes = ("transformer.transformer_blocks.0.attn.to_q.lora_B.weight",
              "transformer.single_transformer_blocks.0.proj_mlp.lora_B.weight")
    probe = {key: adapter_state[key] for key in probes}
    del adapter_state
    seconds, facts, last, vae = {"decode": [], "step": [], "request": []}, {}, [], {"max_elements": 0}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    wrapped = ((AutoencoderKL3D, "decode"), (FluxPipeline, "denoise_step"), (FluxPipeline, "__call__"))
    originals = {name: getattr(cls, name) for cls, name in wrapped}
    pieces = autoencoders._pieces
    request = timed("request", originals["__call__"])
    step = timed("step", originals["denoise_step"])

    def call(self, *args, **kwargs):
        facts["scheduler"] = type(self.scheduler).__name__
        facts["dynamic_shifting"] = self.scheduler.use_dynamic_shifting
        params = dict(self.transformer.module.named_parameters())
        facts["lora_loaded"] = all(bool(torch.equal(params[key[len("transformer."):]].detach().cpu(),
                                                    value.to(params[key[len("transformer."):]].dtype)))
                                   for key, value in probe.items())
        facts["lora_b_nonzero"] = all(bool(value.any()) for value in probe.values())
        image = request(self, *args, **kwargs)
        facts["image_shape"], facts["image_dtype"] = list(image.shape), str(image.dtype)
        return image

    def denoise(self, *args, **kwargs):
        last[:] = [self, args, kwargs]
        return step(self, *args, **kwargs)

    def counted_pieces(size, elements):
        vae["max_elements"] = max(vae["max_elements"], elements)
        return pieces(size, elements)

    AutoencoderKL3D.decode = timed("decode", originals["decode"])
    FluxPipeline.denoise_step, FluxPipeline.__call__ = denoise, call
    autoencoders._pieces = counted_pieces
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        paths = inference.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, peak_gb = _counts(), torch.cuda.max_memory_allocated() / 1e9
    finally:
        autoencoders._pieces = pieces
        for cls, name in wrapped:
            setattr(cls, name, originals[name])
    with torch.inference_mode():
        prof = profile_device(lambda: originals["denoise_step"](last[0], *last[1], **last[2]))
    del last[:]
    written = cv2.imread(paths[0])
    expected = {k_: FLUX_LAYERS * FLUX_SERVE_STEPS if k_ in ("k1", "prep") else 0 for k_ in launches}
    in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep")}
    phase("flux_serve", card=card, entry="python -m finetrainers_tpu_torch.inference", argv=argv[:-6],
          steps=FLUX_SERVE_STEPS, steps_note="cut from the default 28", tokens=FLUX_SERVE_TOKENS,
          text_tokens=FLUX_TEXT, request_s=seconds["request"], step_s=seconds["step"],
          vae_decode_s=seconds["decode"], main_wall_s=wall_s, peak_memory_gb=peak_gb, launches=launches,
          launches_expected=expected, vae_max_elements=vae["max_elements"],
          vae_split_elements=autoencoders.SPLIT_ELEMENTS,
          written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent)) for p in paths],
          written_shape=list(written.shape) if written is not None else None, **facts)
    phase("flux_serve_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (facts.get("image_shape") == [1024, 1024, 3] and facts.get("image_dtype") == "uint8"
            and facts.get("scheduler") == "FlowMatchEulerScheduler" and facts.get("dynamic_shifting")
            and facts.get("lora_loaded") and facts.get("lora_b_nonzero") and launches == expected
            and len(seconds["step"]) == FLUX_SERVE_STEPS and len(seconds["decode"]) == 1
            and vae["max_elements"] <= autoencoders.SPLIT_ELEMENTS and written is not None
            and list(written.shape) == [1024, 1024, 3] and paths[0].endswith(".png")):
        raise AssertionError("Flux serving through the runner failed its checks")
    phase("flux_serve_freed", memory_allocated_gb=_free_cuda())
    return launches, in_step


# HunyuanVideo at full width: its kernels at its shapes (the joint attention and the token refiner's), the
# modal_labs_dissolve example's run through the command line at its own 49x480x768 bucket, then a 49x480x768
# text-to-video request through the inference runner with the exported adapter.


def hunyuan_tables(grid):
    """HunyuanVideo's (1, S, 128) fp32 tables for 256 text tokens (zero ids:
    identity rows) and a `grid` (frames, rows, cols) of patches whose ids
    move the frame axis too, as the model builds them."""
    from finetrainers_tpu_torch.models.flux import flux_rope_freqs, rope_tables
    from finetrainers_tpu_torch.models.hunyuan_video import video_ids

    ids = torch.cat([torch.zeros(HUNYUAN_TEXT, 3, device="cuda"), video_ids(*grid, torch.device("cuda"))])
    return tuple(t[None].contiguous() for t in rope_tables(*flux_rope_freqs(ids, HUNYUAN_AXES)))


def check_hunyuan_kernels(card):
    """K1 and the pre-pass at the joint self-attention (1, 24, 18976, 18976,
    128, a last tile of 32 rows) with the frame-axis tables, head by head
    against their plain version; the pre-pass, K2 and K3 there against
    `flash_backward_reference` head by head; then the refiner's
    self-attention over 256 text slots, (1, 24, 256, 256, 128) with kv_lens
    [65] and (2, ...) with [65, 256], whose second kv tile holds no valid key:
    K1 (every row, the padded query rows too, against its plain version; k/v
    past kv_lens ignored), K2 with its q loop split in 2 and the reduce pass
    (B=1; 48 kv CTAs are fewer than the 132 SMs), K3, and dk = dv = 0 exactly
    past kv_lens. Returns the worst errors and the records by case."""
    k1_err, k1 = check_k1_wan(card, {"hunyuan_joint_self_tables": (
        1, HUNYUAN_HEADS, lambda: hunyuan_tables(HUNYUAN_RUN_GRID))}, phase_name="hunyuan_kernel_checks")
    refiner = {"hunyuan_refiner_self_kv_lens": dict(b=1, lens=[HUNYUAN_REFINER_VALID]),
               "hunyuan_refiner_self_kv_lens_b2": dict(b=2, lens=[HUNYUAN_REFINER_VALID, HUNYUAN_TEXT])}
    refiner = {name: dict(c, n=HUNYUAN_HEADS, sq=HUNYUAN_TEXT, skv=HUNYUAN_TEXT, h=128, rope=None)
               for name, c in refiner.items()}
    refiner_err, refiner_k1 = check_k1(card, refiner, phase_name="hunyuan_kernel_checks")
    bwd_err, bwd = check_k2k3(card, {
        "hunyuan_joint_self_tables": dict(b=1, n=HUNYUAN_HEADS, sq=HUNYUAN_TOKENS, skv=HUNYUAN_TOKENS, h=128,
                                          lens=None, rope="hunyuan"),
        **{name: dict(c, dead_tile=True) for name, c in refiner.items()}}, phase_name="hunyuan_kernel_checks")
    return max(k1_err, refiner_err), {**k1, **refiner_k1}, bwd_err, bwd


def ops_attn_remat_factor(cfg: dict, lora_rank: int, S: int) -> float:
    """The share of the forward's matmul FLOPs (floor_bench's per-layer terms,
    as `flux_train_step_flops` counts them) that "ops_attn" recomputes: all
    but the attention scores and values."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    per_layer = flux_train_step_flops(cfg, lora_rank, 0.0, B=1, S=S) / 2.0 / (2 * cfg["num_layers"]
                                                                               + cfg["num_single_layers"])
    return 1.0 - 2 * 2 * S * S * d / per_layer


def hunyuan_run_data(root):
    """HUNYUAN_RUN_VIDEOS seeded videos at the example's 49x480x768 bucket (mp4v,
    smooth colour blobs), their `metadata.csv` with DISSOLVE captions, the example's
    training.json pointing at them, and its first validation prompt at
    49x480x768 with 2 denoising steps. Returns (training.json, validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    frames, height, width = HUNYUAN_BUCKET
    rng = np.random.RandomState(14)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(HUNYUAN_RUN_VIDEOS):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25, (width, height))
            coarse = (rng.rand(frames, height // 32, width // 32, 3) * 255).astype(np.uint8)
            for frame in coarse:
                writer.write(cv2.resize(frame, (width, height), interpolation=cv2.INTER_LINEAR))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4",
                        "caption": f"DISSOLVE A figurine number {i} dissolves into a cloud of particles."})
    training = json.loads((HUNYUAN_EXAMPLE / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((HUNYUAN_EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2)]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json"


@contextlib.contextmanager
def vae_pieces_seen():
    """Record the largest element count the VAE's convs and GroupNorms meet
    (`autoencoders._pieces`): past SPLIT_ELEMENTS they run in pieces."""
    from finetrainers_tpu_torch.models import autoencoders

    pieces, seen = autoencoders._pieces, {"max_elements": 0}

    def counted_pieces(size, elements):
        seen["max_elements"] = max(seen["max_elements"], elements)
        return pieces(size, elements)

    autoencoders._pieces = counted_pieces
    try:
        yield seen
    finally:
        autoencoders._pieces = pieces


def _refiner_and_joint(ms_list, refiner):
    """Launch times of one kernel class in a step split into the refiner's
    (its `refiner` shortest: 256 slots against 18,976 tokens) and the joint
    attention's: (median joint ms, median refiner ms)."""
    ranked = sorted(ms_list)
    return _median(ranked[refiner:]), _median(ranked[:refiner])


def hunyuan_run(card):
    """The modal_labs_dissolve example's run through
    `finetrainers_tpu_torch.train.main` with its train.sh flags on one card
    (precompute once, `transformer:ring`, slicing and tiling, rank 32, the
    example's AdamW, logit-normal weighting, bf16), with "ops_attn" for the
    example's "ops" (which needs ~120 GB at this size), from 2 videos on disk
    at its own 49x480x768 bucket (18,976 tokens): 3 steps, then the final
    validation from the exported adapter in a fresh model (one request, 2
    steps of 50, 49x480x768). Each step's seconds, launches, K2 reduce passes
    and peak memory, model TFLOP/s by floor_bench's formula with "ops_attn"'s
    remat factor, precompute seconds per item, whether the VAE ran in pieces,
    the validation's seconds and launches; the run's last step profiled.
    Returns the run's launches, reduce passes, the adapter's directory and
    the in-step times."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models import autoencoders
    from finetrainers_tpu_torch.models.hunyuan_video import HUNYUAN_VIDEO_CONFIG

    t0 = time.perf_counter()
    training_json, validation_json = hunyuan_run_data(SMOKE_DIR / "hunyuan_run_data")
    data_s = time.perf_counter() - t0
    out_dir = SMOKE_DIR / "hunyuan_run"
    argv = train_sh_argv(HUNYUAN_EXAMPLE, dataset_config=training_json, validation_dataset_file=validation_json,
                         output_dir=out_dir, report_to="jsonl", train_steps=HUNYUAN_RUN_STEPS,
                         precomputation_items=HUNYUAN_RUN_VIDEOS, gradient_checkpointing_type=HUNYUAN_RUN_POLICY)
    with vae_pieces_seen() as vae, counted_run(profile_step=HUNYUAN_RUN_STEPS) as rec:
        trainer = train_cli.main(argv)
    steps, validations, peaks, run_s, launches, reduce, prof = (
        rec[k_] for k_ in ("steps", "validations", "peaks", "run_s", "launches", "reduce", "profile"))
    module = trainer.transformer.module
    base_params = sum(p.numel() for n, p in module.named_parameters() if n not in trainer._trainable)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    shape_ok = (base_params == HUNYUAN_PARAMS and lora_params == HUNYUAN_LORA_PARAMS
                and len(module.transformer_blocks) + len(module.single_transformer_blocks) == HUNYUAN_LAYERS
                and module.context_embedder.token_refiner.num_layers == HUNYUAN_REFINER_LAYERS
                and module.gradient_checkpointing == HUNYUAN_RUN_POLICY
                and trainer.attn_provider_training == {"transformer": "ring"})
    precomputed = out_dir / "precomputed" / PRECOMPUTED_DIR_NAME
    items = [dict(np.load(precomputed / f"{kind}-0.npz")) for kind in ("condition", "latent")]
    latent_shape = list(items[1]["latents"].shape)
    text_valid = int(items[0]["encoder_attention_mask"].sum())
    del trainer, module
    freed_gb = _free_cuda()

    log = [json.loads(line) for line in (out_dir / "logs" / "finetrainers-tpu-hunyuan_video.jsonl").read_text()
           .splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    adapter = out_dir / "lora_weights" / f"{HUNYUAN_RUN_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    videos = sorted((out_dir / "validation").rglob("*.mp4"))
    layers = HUNYUAN_LAYERS + HUNYUAN_REFINER_LAYERS
    # A step under "ops_attn": K4's outputs saved, so K1 runs in the forward only (60 joint, 2 refiner), the
    # pre-pass before each forward and each backward, K2 and K3 in each backward. The reduce pass: the refiner's
    # K2 has 24 heads x 2 kv tiles = 48 CTAs, fewer than the H100's 132 SMs, and 4 q tiles of 64 rows, so its q
    # loop is cut in 2 and the reduce pass runs once a refiner block; the joint attention's 24 x 149 = 3576 CTAs
    # are not cut.
    step_want = dict(k1=layers, prep=2 * layers, k2=layers, k3=layers)
    want = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    steps_ok = all(st["launches"] == want and st["reduce"] == HUNYUAN_REFINER_LAYERS for st in steps)
    validation_want = {"k1": 2 * layers, "prep": 2 * layers}  # 2 denoising steps, no CFG
    validations_ok = (len(validations) == 1 and validations[0]["final"]
                      and validations[0]["launches"] == validation_want)
    timed = [st["seconds"] for st in steps[1:] if not st["profiled"]]  # step 2; the last step is profiled
    remat = ops_attn_remat_factor(HUNYUAN_VIDEO_CONFIG, HUNYUAN_RANK, HUNYUAN_TOKENS)
    flops = flux_train_step_flops(HUNYUAN_VIDEO_CONFIG, HUNYUAN_RANK, remat, B=1, S=HUNYUAN_TOKENS)
    median_s = statistics.median(timed)
    in_step = {cls: _refiner_and_joint(prof["launches"][cls], 2 * HUNYUAN_REFINER_LAYERS if cls == "prep"
                                       else HUNYUAN_REFINER_LAYERS) for cls in ("k1", "prep", "k2", "k3")}
    in_step["k2_reduce"] = _median(prof["launches"]["k2_reduce"])
    phase("hunyuan_run", card=card, entry="python -m finetrainers_tpu_torch.train", argv=[str(a) for a in argv],
          policy_note=f"{HUNYUAN_RUN_POLICY} for the example's ops, which does not fit one card at this bucket",
          bucket=list(HUNYUAN_BUCKET), tokens=HUNYUAN_TOKENS, latents_shape=latent_shape, text_valid=text_valid,
          published_shape=shape_ok, base_params=base_params, lora_params=lora_params, data_write_s=data_s,
          precompute_s=precompute_s, precompute_s_per_item=precompute_s / HUNYUAN_RUN_VIDEOS, peaks_gb=peaks,
          step_seconds=[st["seconds"] for st in steps], median_step_s_2_to_3=median_s,
          step_peaks_gb=[st["peak_gb"] for st in steps], step_launches=steps[0]["launches"],
          step_reduce_passes=[st["reduce"] for st in steps], step_launches_all_exact=steps_ok,
          remat_factor=remat, model_flops_per_step=flops, model_tflops=flops / median_s / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, losses=losses, validations=validations,
          validations_launches_exact=validations_ok, validation_videos=[str(v.relative_to(SMOKE_DIR)) for v in videos],
          vae_max_elements=vae["max_elements"], vae_split_elements=autoencoders.SPLIT_ELEMENTS,
          vae_split=vae["max_elements"] > autoencoders.SPLIT_ELEMENTS, run_s=run_s, launches=launches,
          reduce_passes=reduce, export=str(adapter.relative_to(SMOKE_DIR.parent.parent)), export_keys=len(state),
          export_lora_config=config, memory_after_free_gb=freed_gb)
    phase("hunyuan_run_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch_joint_and_refiner=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (shape_ok and steps_ok and validations_ok and len(steps) == HUNYUAN_RUN_STEPS and all(np.isfinite(losses))
            and len(losses) == HUNYUAN_RUN_STEPS and len(state) == 2 * (20 * 12 + 40 * 5 + 2 * 6)
            and config.get("r") == HUNYUAN_RANK and latent_shape == [1, 32, 13, 60, 96] and len(videos) == 1
            and reduce == HUNYUAN_REFINER_LAYERS * HUNYUAN_RUN_STEPS):
        raise AssertionError("the modal_labs_dissolve example's run failed its checks")
    del state
    return dict(launches=launches, reduce=reduce, adapter=adapter, in_step=in_step)


def hunyuan_checkpoint_dir():
    """A model directory that holds only `scheduler/scheduler_config.json`, as the
    public HunyuanVideo checkpoint names its scheduler."""
    root = SMOKE_DIR / "hunyuan_checkpoint"
    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(HUNYUAN_SCHEDULER_CONFIG))
    return root


def hunyuan_serve(card, adapter):
    """One 49x480x768 text-to-video request of full-width HunyuanVideo through
    the port's runner, `inference.main`, with `--attn_provider flash` as the
    example passes it, the runner's default guidance 5.0 embedded, 3
    flow-match Euler steps of 50 with shift 7 read from the scheduler config,
    and the adapter `hunyuan_run` exported. The VAE decode, each denoise step
    and the request are timed by synced wrappers; the video must be finite,
    (49, 480, 768, 3) uint8, every LoRA factor of the served model the
    adapter's, K1 and the pre-pass 62 times a step (60 joint, 2 refiner) and no
    other kernel. Then one denoise step profiled."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.models import autoencoders
    from finetrainers_tpu_torch.models.autoencoders import AutoencoderKL3D
    from finetrainers_tpu_torch.models.hunyuan_video import HunyuanVideoPipeline

    out_dir = SMOKE_DIR / "hunyuan_serve"
    frames, height, width = HUNYUAN_BUCKET
    argv = ["--model_name", "hunyuan_video", "--pretrained_model_name_or_path", str(hunyuan_checkpoint_dir()),
            "--inference_type", "text_to_video", "--prompt", "DISSOLVE A chess piece crumbles into glowing embers "
            "that scatter upward.", "--num_frames", str(frames), "--height", str(height), "--width", str(width),
            "--num_inference_steps", str(HUNYUAN_SERVE_STEPS), "--attn_provider", "flash", "--enable_slicing",
            "--enable_tiling", "--lora_weights", str(adapter), "--output_dir", str(out_dir), "--seed", "0"]
    seconds, facts, last = {"decode": [], "step": [], "request": []}, {}, []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    wrapped = ((AutoencoderKL3D, "decode"), (HunyuanVideoPipeline, "denoise_step"), (HunyuanVideoPipeline, "__call__"))
    originals = {name: getattr(cls, name) for cls, name in wrapped}
    request = timed("request", originals["__call__"])
    step = timed("step", originals["denoise_step"])

    def call(self, *args, **kwargs):
        facts["scheduler"] = type(self.scheduler).__name__
        facts["shift"] = self.scheduler.shift
        facts["guidance_scale"] = kwargs.get("guidance_scale")
        params = dict(self.transformer.module.named_parameters())
        adapter_state, _ = load_lora_weights(str(adapter))
        facts["lora_factors"] = len(adapter_state)
        facts["lora_loaded"] = all(bool(torch.equal(params[key[len("transformer."):]].detach(),
                                                    value.to(params[key[len("transformer."):]].device)))
                                   for key, value in adapter_state.items())
        facts["lora_b_nonzero"] = all(bool(adapter_state[f"transformer.{name}.lora_B.weight"].any()) for name in (
            "transformer_blocks.0.attn.to_q", "single_transformer_blocks.0.proj_mlp",
            "context_embedder.token_refiner.refiner_blocks_0.attn.to_q"))
        del adapter_state
        video = request(self, *args, **kwargs)
        facts["video_shape"], facts["video_dtype"] = list(video.shape), str(video.dtype)
        return video

    def denoise(self, *args, **kwargs):
        last[:] = [self, args, kwargs]
        return step(self, *args, **kwargs)

    AutoencoderKL3D.decode = timed("decode", originals["decode"])
    HunyuanVideoPipeline.denoise_step, HunyuanVideoPipeline.__call__ = denoise, call
    try:
        with vae_pieces_seen() as vae:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            paths = inference.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches, peak_gb = _counts(), torch.cuda.max_memory_allocated() / 1e9
    finally:
        for cls, name in wrapped:
            setattr(cls, name, originals[name])
    with torch.inference_mode():
        prof = profile_device(lambda: originals["denoise_step"](last[0], *last[1], **last[2]))
    del last[:]
    from finetrainers_tpu_torch.data.utils import load_video

    written = load_video(paths[0], to_float=False)
    layers = HUNYUAN_LAYERS + HUNYUAN_REFINER_LAYERS
    expected = {k_: layers * HUNYUAN_SERVE_STEPS if k_ in ("k1", "prep") else 0 for k_ in launches}
    in_step = {cls: _refiner_and_joint(prof["launches"][cls], HUNYUAN_REFINER_LAYERS) for cls in ("k1", "prep")}
    phase("hunyuan_serve", card=card, entry="python -m finetrainers_tpu_torch.inference", argv=argv[:-6],
          steps=HUNYUAN_SERVE_STEPS, steps_note="cut from the request's 50", tokens=HUNYUAN_TOKENS,
          text_tokens=HUNYUAN_TEXT, request_s=seconds["request"], step_s=seconds["step"],
          vae_decode_s=seconds["decode"], main_wall_s=wall_s, peak_memory_gb=peak_gb, launches=launches,
          launches_expected=expected, vae_max_elements=vae["max_elements"],
          vae_split_elements=autoencoders.SPLIT_ELEMENTS, vae_split=vae["max_elements"] > autoencoders.SPLIT_ELEMENTS,
          written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent)) for p in paths],
          written_shape=list(written.shape), **facts)
    phase("hunyuan_serve_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch_joint_and_refiner=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (facts.get("video_shape") == [frames, height, width, 3] and facts.get("video_dtype") == "uint8"
            and facts.get("scheduler") == "FlowMatchEulerScheduler" and facts.get("shift") == 7.0
            and facts.get("guidance_scale") == 5.0 and facts.get("lora_loaded") and facts.get("lora_b_nonzero")
            and facts.get("lora_factors") == 2 * (20 * 12 + 40 * 5 + 2 * 6) and launches == expected
            and len(seconds["step"]) == HUNYUAN_SERVE_STEPS and len(seconds["decode"]) == 1
            and list(written.shape) == [frames, height, width, 3] and paths[0].endswith(".mp4")):
        raise AssertionError("HunyuanVideo serving through the runner failed its checks")
    phase("hunyuan_serve_freed", memory_allocated_gb=_free_cuda())
    return launches, in_step


# CogView4-6B at full width with the control trainer: its kernels at its joint self-attention shape, the canny
# control-LoRA example's run through the command line at 1024x1024, then a control-conditioned and a plain
# 1024x1024 request through the inference runner; then the Wan image_condition control example's run.


def cogview4_tables():
    """CogView4's (1, 5120, 128) fp32 tables: the identity on the 1024 text
    rows, then the 64x64 patches' 2D RoPE, as the model builds them."""
    from finetrainers_tpu_torch.models.cogview4 import cogview4_rope_tables

    return tuple(t[None].contiguous() for t in cogview4_rope_tables(COGVIEW4_TEXT, *COGVIEW4_GRID, 128,
                                                                    torch.device("cuda")))


def check_cogview4_kernels(card):
    """K1 and the pre-pass at CogView4's joint self-attention (1, 32, 5120,
    5120, 128; 40 full tiles) and at the CFG batch (2, ...), with the tables,
    against their plain version head by head; the pre-pass, K2 and K3 at the
    training shape against `flash_backward_reference` head by head (32 heads x
    40 kv tiles = 1280 CTAs: no split, no reduce pass). Returns the worst
    errors and the records by case."""
    k1_err, k1 = check_k1_wan(card, {"cogview4_joint_self_tables": (1, COGVIEW4_HEADS, cogview4_tables),
                                     "cogview4_joint_self_tables_b2": (2, COGVIEW4_HEADS, cogview4_tables)},
                              phase_name="cogview4_kernel_checks")
    bwd_err, bwd = check_k2k3(card, {"cogview4_joint_self_tables": dict(
        b=1, n=COGVIEW4_HEADS, sq=COGVIEW4_TOKENS, skv=COGVIEW4_TOKENS, h=128, lens=None, rope="cogview4")},
        phase_name="cogview4_kernel_checks")
    return k1_err, k1, bwd_err, bwd


@contextlib.contextmanager
def counted_run(profile_step=None):
    """Count a run through the trainer (the SFT trainer's `train_step` and
    `_validate`, which the control trainer inherits): per step its seconds,
    launches, K2 reduce passes and peak memory; per validation its seconds,
    launches and peak; the peak of the model load and precompute before the
    first step; and the run's seconds, launches and reduce passes. With
    `profile_step` k, the run's k-th step also runs under `profile_device`
    (its trace in rec["profile"], its seconds the traced window, without the
    trace's parsing), so no extra step is needed to profile it."""
    rec = dict(steps=[], validations=[], peaks={})
    orig_step, orig_validate = SFTTrainer.train_step, SFTTrainer._validate

    def counted_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        before, reduce_before, t = _counts(), flash_bwd_dkdv.reduce_launches, time.perf_counter()
        if not rec["steps"]:
            rec["peaks"]["load_and_precompute_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        profiled = len(rec["steps"]) + 1 == profile_step
        if profiled:
            out = []
            rec["profile"] = profile_device(lambda: out.append(orig_step(self, *args, **kwargs)))
            out = out[0]
        else:
            out = orig_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        after = _counts()
        seconds = rec["profile"]["wall_ms"] / 1e3 if profiled else time.perf_counter() - t
        rec["steps"].append(dict(seconds=seconds, profiled=profiled,
                                 launches={k_: after[k_] - before[k_] for k_ in after},
                                 reduce=flash_bwd_dkdv.reduce_launches - reduce_before,
                                 peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        return out

    def timed_validate(self, step, final=False):
        torch.cuda.synchronize()
        before, t = _counts(), time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        orig_validate(self, step, final)
        torch.cuda.synchronize()
        after = _counts()
        rec["validations"].append(dict(step=step, final=final, seconds=time.perf_counter() - t,
                                       launches={k_: after[k_] - before[k_] for k_ in after
                                                 if after[k_] != before[k_]},
                                       peak_gb=torch.cuda.max_memory_allocated() / 1e9))

    SFTTrainer.train_step, SFTTrainer._validate = counted_step, timed_validate
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        reduce_before, t0 = flash_bwd_dkdv.reduce_launches, time.perf_counter()
        yield rec
        torch.cuda.synchronize()
        rec.update(run_s=time.perf_counter() - t0, launches=_counts(),
                   reduce=flash_bwd_dkdv.reduce_launches - reduce_before)
    finally:
        SFTTrainer.train_step, SFTTrainer._validate = orig_step, orig_validate


def cogview4_run_data(root):
    """4 seeded 1024x1024 PNG photos (64-pixel colour blocks, so Canny finds
    edges) written with cv2, their `metadata.csv`, the example's training.json
    pointing at them, the Canny map of the first photo made by the ported
    processor and written as a PNG, and the example's validation prompt at
    1024x1024 with 2 denoising steps and that map as its control image.
    Returns (training.json, validation.json, the map's path)."""
    import csv

    import cv2

    from finetrainers_tpu_torch.processors import CannyProcessor

    root.mkdir(parents=True, exist_ok=True)
    height, width = COGVIEW4_BUCKET
    rng = np.random.RandomState(15)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(COGVIEW4_RUN_IMAGES):
            coarse = (rng.rand(height // 64, width // 64, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / f"photo{i}.png"),
                        cv2.resize(coarse, (width, height), interpolation=cv2.INTER_NEAREST))
            w.writerow({"file_name": f"photo{i}.png", "caption": f"a photo of a mountain lake at dawn, number {i}"})
    first = cv2.cvtColor(cv2.imread(str(root / "photo0.png")), cv2.COLOR_BGR2RGB)
    edges = CannyProcessor(["control"])(input=np.moveaxis(first.astype(np.float32) / 127.5 - 1.0, -1, 0))["control"]
    edge_map = root / "edge_map.png"
    cv2.imwrite(str(edge_map), ((np.moveaxis(edges, 0, -1) + 1.0) * 127.5).astype(np.uint8))
    training = json.loads((COGVIEW4_EXAMPLE / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((COGVIEW4_EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2, control_image_path=str(edge_map))]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json", edge_map


def cogview4_control_run(card):
    """The canny control-LoRA example's run through
    `finetrainers_tpu_torch.train.main` with its train.sh flags on one card
    (control-lora rank 128, `--control_type canny`, precompute once, "ops"
    remat, `transformer:auto`, slicing and tiling, AdamW with
    `constant_with_warmup`, logit-normal weighting, bf16) from 4 photos on
    disk at its own 1024x1024 bucket (5120 tokens): 4 steps, then the final
    validation from the exports in a fresh widened model (one request with
    the control image, 2 steps of 50, CFG in one batch of 2). Each step's
    seconds, launches, reduce passes and peak memory, model TFLOP/s by
    floor_bench's formula, precompute seconds per item, the validation's
    seconds and launches; the exported adapter plus
    `control_aux_weights.safetensors` reloaded into a fresh widened model
    must give the trained model's forward bit for bit; then one more step
    profiled. Returns the run's launches, the adapter's directory, the
    control image's path and the in-step times."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.trainer.control_trainer import AUX_WEIGHTS_NAME
    from finetrainers_tpu_torch.utils.serialization import safetensors_load_dict

    t0 = time.perf_counter()
    training_json, validation_json, edge_map = cogview4_run_data(SMOKE_DIR / "cogview4_run_data")
    data_s = time.perf_counter() - t0
    out_dir = SMOKE_DIR / "cogview4_run"
    argv = train_sh_argv(COGVIEW4_EXAMPLE, dataset_config=training_json, validation_dataset_file=validation_json,
                         output_dir=out_dir, report_to="jsonl", train_steps=COGVIEW4_RUN_STEPS,
                         precomputation_items=COGVIEW4_RUN_IMAGES)
    with counted_run() as rec:
        trainer = train_cli.main(argv)
    steps, validations = rec["steps"], rec["validations"]
    module = trainer.transformer.module
    n_params = sum(p.numel() for p in module.parameters())
    n_trained = sum(p.numel() for p in trainer._trainable.values())
    shape_ok = (n_params == COGVIEW4_PARAMS and n_trained == COGVIEW4_TRAINED
                and len(module.transformer_blocks) == COGVIEW4_LAYERS
                and trainer.transformer.config["in_channels"] == 32 and module.gradient_checkpointing == "ops"
                and module.patch_embed.proj.weight.dtype == torch.float32
                and trainer.attn_provider_training == {"transformer": "auto"})
    spec = trainer.model_specification
    precomputed = out_dir / "precomputed" / PRECOMPUTED_DIR_NAME
    items = [dict(np.load(precomputed / f"{kind}-0.npz")) for kind in ("condition", "latent")]
    latent_shape, control_shape = list(items[1]["latents"].shape), list(items[1]["control_latents"].shape)
    batch = to_device((spec.collate_conditions([items[0]]), spec.collate_latents([items[1]])), torch.device("cuda"))
    # The exports reloaded into a fresh widened model (the final validation's path) against the trained model.
    fresh = trainer._load_exported_transformer()
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((1, 32, 128, 128), generator=g, device="cuda").to(torch.bfloat16)
    ehs, sizes = batch[0]["encoder_hidden_states"], batch[1]["original_size"]
    with torch.no_grad():
        outs = [m(x, ehs, torch.tensor([500.0], device="cuda"), original_size=sizes, target_size=sizes,
                  crop_coords=torch.zeros_like(sizes)) for m in (fresh.module, module)]
    reload_bit_equal = bool(torch.equal(*outs)) and bool(torch.isfinite(outs[0]).all())
    del fresh, outs, x
    torch.cuda.empty_cache()
    prof = profile_device(lambda: trainer.train_step(*batch))
    del trainer, module, spec, batch
    _free_cuda()

    log = [json.loads(line) for line in (out_dir / "logs" / "finetrainers-tpu-cogview4.jsonl").read_text()
           .splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    adapter = out_dir / "lora_weights" / f"{COGVIEW4_RUN_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    aux = safetensors_load_dict(str(adapter / AUX_WEIGHTS_NAME))
    aux_shapes = {k: list(v.shape) for k, v in aux.items()}
    images = sorted((out_dir / "validation").rglob("*.png"))
    # A step under "ops": K4 saved, so K1 runs in the forward only, the pre-pass before each forward and backward,
    # K2 and K3 in each backward; no reduce pass (32 heads x 40 kv tiles = 1280 CTAs, over the 132 SMs).
    step_want = dict(k1=COGVIEW4_LAYERS, prep=2 * COGVIEW4_LAYERS, k2=COGVIEW4_LAYERS, k3=COGVIEW4_LAYERS)
    want = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    steps_ok = all(st["launches"] == want and st["reduce"] == 0 for st in steps)
    validation_want = {"k1": 2 * COGVIEW4_LAYERS, "prep": 2 * COGVIEW4_LAYERS}  # 2 steps, CFG in one batch
    validations_ok = (len(validations) == 1 and validations[0]["final"]
                      and validations[0]["launches"] == validation_want)
    median_s = statistics.median([st["seconds"] for st in steps][1:])
    flops = joint_train_step_flops(COGVIEW4_LAYERS, 4096, COGVIEW4_RANK, 0.0, B=1, S=COGVIEW4_TOKENS)
    in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep", "k2", "k3")}
    phase("cogview4_control_run", card=card, entry="python -m finetrainers_tpu_torch.train",
          argv=[str(a) for a in argv], bucket=list(COGVIEW4_BUCKET), tokens=COGVIEW4_TOKENS,
          latents_shape=latent_shape, control_latents_shape=control_shape, published_shape=shape_ok,
          params=n_params, trained_params=n_trained, data_write_s=data_s, precompute_s=precompute_s,
          precompute_s_per_item=precompute_s / COGVIEW4_RUN_IMAGES, peaks_gb=rec["peaks"],
          step_seconds=[st["seconds"] for st in steps], median_step_s_2_to_4=median_s,
          step_peaks_gb=[st["peak_gb"] for st in steps], step_launches=steps[0]["launches"],
          step_reduce_passes=[st["reduce"] for st in steps], step_launches_all_exact=steps_ok,
          model_flops_per_step=flops, model_tflops=flops / median_s / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, losses=losses, validations=validations,
          validations_launches_exact=validations_ok, validation_images=[str(i.relative_to(SMOKE_DIR)) for i in images],
          run_s=rec["run_s"], launches=rec["launches"], reduce_passes=rec["reduce"],
          export=str(adapter.relative_to(SMOKE_DIR.parent.parent)), export_keys=len(state),
          export_lora_config=config, aux_weights=aux_shapes, reload_forward_bit_equal=reload_bit_equal)
    phase("cogview4_control_run_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (shape_ok and steps_ok and validations_ok and reload_bit_equal and len(steps) == COGVIEW4_RUN_STEPS
            and len(losses) == COGVIEW4_RUN_STEPS and all(np.isfinite(losses))
            and len(state) == 2 * 6 * COGVIEW4_LAYERS and config.get("r") == COGVIEW4_RANK
            and aux_shapes == {"patch_embed_proj.bias": [4096], "patch_embed_proj.kernel": [128, 4096]}
            and latent_shape == control_shape == [1, 32, 128, 128] and len(images) == 1 and rec["reduce"] == 0):
        raise AssertionError("the canny control example's run failed its checks")
    del state, aux
    return dict(launches=rec["launches"], reduce=rec["reduce"], adapter=adapter, edge_map=edge_map,
                in_step=in_step)


def cogview4_serve(card, adapter, edge_map):
    """Two 1024x1024 requests through the port's runner, `inference.main`,
    each 4 Euler steps of 50 with the runner's guidance 5.0 (CFG in one batch
    of 2) under `--attn_provider flash`, slicing and tiling, as
    examples/inference/cogview4/cogview4_text_to_image.sh passes them: one
    with `--training_type control-lora`, the adapter and aux weights
    `cogview4_control_run` exported and its Canny map as the control image;
    one plain text-to-image request. Per request: its seconds, each denoise
    step's, the decode's, the peak, launches (K1 and the pre-pass 28 a step,
    no other kernel), a finite (1024, 1024, 3) PNG; for the control one, the
    served model's injection layer is the aux file's. Then one denoise step
    of each profiled."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.models.autoencoders import AutoencoderKL3D
    from finetrainers_tpu_torch.models.cogview4 import CogView4Pipeline
    from finetrainers_tpu_torch.trainer.control_trainer import AUX_WEIGHTS_NAME
    from finetrainers_tpu_torch.utils.serialization import safetensors_load_dict

    import cv2

    kernel = safetensors_load_dict(str(adapter / AUX_WEIGHTS_NAME))["patch_embed_proj.kernel"]
    base = ["--model_name", "cogview4", "--pretrained_model_name_or_path", str(SMOKE_DIR / "cogview4_checkpoint"),
            "--inference_type", "text_to_image", "--prompt", "a photo of a mountain lake at dawn", "--height",
            str(COGVIEW4_BUCKET[0]), "--width", str(COGVIEW4_BUCKET[1]), "--num_inference_steps",
            str(COGVIEW4_SERVE_STEPS), "--attn_provider", "flash", "--enable_slicing", "--enable_tiling",
            "--seed", "31337"]
    requests = {"control": base + ["--training_type", "control-lora", "--lora_weights", str(adapter),
                                   "--control_image_path", str(edge_map)],
                "plain": list(base)}
    records, expected = {}, {k_: COGVIEW4_LAYERS * COGVIEW4_SERVE_STEPS if k_ in ("k1", "prep") else 0
                             for k_ in _COUNTED}
    for name, argv in requests.items():
        argv = argv + ["--output_dir", str(SMOKE_DIR / f"cogview4_serve_{name}")]
        seconds, facts, last = {"decode": [], "step": [], "request": []}, {}, []

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                seconds[key].append(time.perf_counter() - t0)
                return out
            return wrapper

        wrapped = ((AutoencoderKL3D, "decode"), (CogView4Pipeline, "denoise_step"), (CogView4Pipeline, "__call__"))
        originals = {attr: getattr(cls, attr) for cls, attr in wrapped}
        request, step = timed("request", originals["__call__"]), timed("step", originals["denoise_step"])

        def call(self, *args, **kwargs):
            module = self.transformer.module
            facts.update(in_channels=self.transformer.config["in_channels"],
                         control=kwargs.get("control_image") is not None, guidance_scale=kwargs.get("guidance_scale"),
                         lora_rank=module.transformer_blocks[0].attn1.to_q.rank,
                         injection_is_aux=bool(torch.equal(module.patch_embed.proj.weight.detach().cpu().float(),
                                                           kernel.T.to(torch.bfloat16).float()))
                         if kernel.shape[0] == module.patch_embed.proj.in_features else False)
            image = request(self, *args, **kwargs)
            facts["image_shape"], facts["image_dtype"] = list(image.shape), str(image.dtype)
            return image

        def denoise(self, *args, **kwargs):
            last[:] = [self, args, kwargs]
            return step(self, *args, **kwargs)

        AutoencoderKL3D.decode = timed("decode", originals["decode"])
        CogView4Pipeline.denoise_step, CogView4Pipeline.__call__ = denoise, call
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            paths = inference.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches, peak_gb = _counts(), torch.cuda.max_memory_allocated() / 1e9
        finally:
            for cls, attr in wrapped:
                setattr(cls, attr, originals[attr])
        with torch.inference_mode(), attention_provider("flash"):
            prof = profile_device(lambda: originals["denoise_step"](last[0], *last[1], **last[2]))
        del last[:]
        written = cv2.imread(paths[0])
        in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep")}
        phase("cogview4_serve", card=card, request=name, entry="python -m finetrainers_tpu_torch.inference",
              argv=argv[:-2], steps=COGVIEW4_SERVE_STEPS, steps_note="cut from the request's 50",
              tokens=COGVIEW4_TOKENS, text_tokens=COGVIEW4_TEXT, request_s=seconds["request"], step_s=seconds["step"],
              vae_decode_s=seconds["decode"], main_wall_s=wall_s, peak_memory_gb=peak_gb, launches=launches,
              launches_expected=expected, written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent))
                                                   for p in paths],
              written_shape=list(written.shape) if written is not None else None, **facts,
              profile=dict(step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                           ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
                           ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()}))
        control = name == "control"
        if not (facts.get("image_shape") == [1024, 1024, 3] and facts.get("image_dtype") == "uint8"
                and facts.get("control") is control and facts.get("in_channels") == (32 if control else 16)
                and facts.get("lora_rank") == (COGVIEW4_RANK if control else 0)
                and facts.get("injection_is_aux") is control and facts.get("guidance_scale") == 5.0
                and launches == expected and len(seconds["step"]) == COGVIEW4_SERVE_STEPS
                and len(seconds["decode"]) == 1 and written is not None and list(written.shape) == [1024, 1024, 3]):
            raise AssertionError(f"CogView4 serving ({name}) through the runner failed its checks")
        records[name] = dict(launches=launches, in_step=in_step)
        _free_cuda()
    phase("cogview4_serve_freed", memory_allocated_gb=_free_cuda())
    return records


def wan_control_run_data(root):
    """WAN_RUN_VIDEOS seeded videos at 49x480x832 and, for each, its paired control video
    (another seeded clip), written with cv2; their `metadata.csv` with the
    `control_video` column; the example's training.json pointing at them, and
    its validation prompt at 49x480x832 with 2 denoising steps and the first
    control video. Returns (training.json, validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    frames, height, width = WAN_RUN_BUCKET
    rng = np.random.RandomState(16)

    def write(path):
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (width, height))
        coarse = (rng.rand(frames, height // 32, width // 32, 3) * 255).astype(np.uint8)
        for frame in coarse:
            writer.write(cv2.resize(frame, (width, height), interpolation=cv2.INTER_LINEAR))
        writer.release()

    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption", "control_video"])
        w.writeheader()
        for i in range(WAN_RUN_VIDEOS):
            write(root / f"clip{i}.mp4")
            write(root / f"control{i}.mp4")
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"a sailboat number {i} drifting across a calm bay",
                        "control_video": f"control{i}.mp4"})
    training = json.loads((WAN_CONTROL_EXAMPLE / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((WAN_CONTROL_EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2,
                               control_video_path=str(root / "control0.mp4"))]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json"


def wan_control_run(card):
    """The Wan image_condition example's run through
    `finetrainers_tpu_torch.train.main` with its train.sh flags on one card
    (control-lora rank 128, `--control_type none` with each video's paired
    `control_video`, frame conditioning `index` 0, "ops" remat,
    `transformer:ring`, slicing and tiling, bf16) at 49x480x832 (20,280
    tokens): 4 steps, each launching K1 60, the pre-pass 120, K2 60 with 30
    reduce passes and K3 60 times; then the final validation from the
    exports in a fresh widened model through the pipeline's control branch
    (one request with a control video, 2 steps of 50, CFG: K1 and the
    pre-pass 120). Step seconds, peaks, precompute seconds per item, the
    validation's seconds. Returns the run's launches and reduce passes."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models.wan import WanPipeline
    from finetrainers_tpu_torch.trainer.control_trainer import AUX_WEIGHTS_NAME
    from finetrainers_tpu_torch.utils.serialization import safetensors_load_dict

    t0 = time.perf_counter()
    training_json, validation_json = wan_control_run_data(SMOKE_DIR / "wan_control_run_data")
    data_s = time.perf_counter() - t0
    out_dir = SMOKE_DIR / "wan_control_run"
    argv = train_sh_argv(WAN_CONTROL_EXAMPLE, dataset_config=training_json, validation_dataset_file=validation_json,
                         output_dir=out_dir, report_to="jsonl", train_steps=WAN_RUN_STEPS,
                         precomputation_items=WAN_RUN_VIDEOS)
    with counted(WanPipeline, "control_channels") as control_calls, counted_run() as rec:
        trainer = train_cli.main(argv)
    steps, validations = rec["steps"], rec["validations"]
    module, spec = trainer.transformer.module, trainer.model_specification
    n_params = sum(p.numel() for p in module.parameters())
    n_trained = sum(p.numel() for p in trainer._trainable.values())
    shape_ok = (n_params == WAN_CONTROL_PARAMS and n_trained == WAN_CONTROL_TRAINED
                and len(module.blocks) == WAN_LAYERS
                and trainer.transformer.config["in_channels"] == 32 and module.gradient_checkpointing == "ops"
                and (spec.frame_conditioning_type, spec.frame_conditioning_index) == ("index", 0)
                and trainer.attn_provider_training == {"transformer": "ring"})
    latent = np.load(out_dir / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz")
    latent_shape, control_shape = list(latent["latents"].shape), list(latent["control_latents"].shape)
    del trainer, module, spec, latent
    _free_cuda()
    log = _jsonl(out_dir)
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    adapter = out_dir / "lora_weights" / f"{WAN_RUN_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    aux_shapes = {k: list(v.shape) for k, v in safetensors_load_dict(str(adapter / AUX_WEIGHTS_NAME)).items()}
    videos = sorted((out_dir / "validation").rglob("*.mp4"))
    want = {k_: WAN_RUN_STEP_LAUNCHES.get(k_, 0) for k_ in _COUNTED}
    steps_ok = all(st["launches"] == want and st["reduce"] == WAN_RUN_REDUCE for st in steps)
    validation_want = 2 * WAN_LAYERS * 2  # self and cross a block, 2 denoising steps, CFG in one batch
    validations_ok = (len(validations) == 1 and validations[0]["final"]
                      and validations[0]["launches"] == {"k1": validation_want, "prep": validation_want})
    phase("wan_control_run", card=card, entry="python -m finetrainers_tpu_torch.train", argv=[str(a) for a in argv],
          bucket=list(WAN_RUN_BUCKET), tokens=WAN_RUN_TOKENS, latents_shape=latent_shape,
          control_latents_shape=control_shape, published_shape=shape_ok, params=n_params, trained_params=n_trained,
          data_write_s=data_s, precompute_s=precompute_s, precompute_s_per_item=precompute_s / WAN_RUN_VIDEOS,
          peaks_gb=rec["peaks"], step_seconds=[st["seconds"] for st in steps],
          median_step_s_2_to_4=statistics.median([st["seconds"] for st in steps][1:]),
          step_peaks_gb=[st["peak_gb"] for st in steps], step_launches=steps[0]["launches"],
          step_reduce_passes=[st["reduce"] for st in steps], step_launches_all_exact=steps_ok, losses=losses,
          validations=validations, validations_launches_exact=validations_ok,
          pipeline_control_branch_calls=control_calls[0], validation_videos=[str(v.relative_to(SMOKE_DIR))
                                                                             for v in videos],
          run_s=rec["run_s"], launches=rec["launches"], reduce_passes=rec["reduce"],
          export=str(adapter.relative_to(SMOKE_DIR.parent.parent)), export_keys=len(state), export_lora_config=config,
          aux_weights=aux_shapes)
    if not (shape_ok and steps_ok and validations_ok and len(steps) == WAN_RUN_STEPS and len(losses) == WAN_RUN_STEPS
            and all(np.isfinite(losses)) and control_calls[0] == 1 and len(videos) == 1
            and len(state) == 2 * 10 * WAN_LAYERS and config.get("r") == 128
            and aux_shapes == {"patch_embedding.bias": [1536], "patch_embedding.kernel": [128, 1536]}
            and latent_shape == control_shape == [1, 32, *WAN_RUN_GRID[:1], 60, 104]
            and rec["reduce"] == WAN_RUN_REDUCE * WAN_RUN_STEPS):
        raise AssertionError("the Wan image_condition control example's run failed its checks")
    del state
    return dict(launches=rec["launches"], reduce=rec["reduce"])


# CogVideoX-5B at full width: its kernels at its joint self-attention shape (the first long head-dim-64 shape),
# the crush_smol_lora example's run through the command line at its own 81x480x768 bucket, then an 81x480x768
# text-to-video request through the inference runner with DDIM and the exported adapter.


def cogvideox_tables():
    """CogVideoX-5B's (1, 30466, 64) fp32 tables: the identity on the 226 text
    rows, then the 21x30x48 patches' 3D RoPE, as the model builds them."""
    from finetrainers_tpu_torch.models.cogvideox import cogvideox_rope_tables

    return tuple(t[None].contiguous() for t in cogvideox_rope_tables(COGVIDEOX_TEXT, *COGVIDEOX_GRID, 64,
                                                                     torch.device("cuda")))


def check_h32_kernels(card):
    """Every kernel at head dim 32 against its plain version: K1, the
    pre-pass, K2 (its q loop split, with the reduce pass, and unsplit), K3, K5
    with its dq emit (its q loop split likewise), K7a, K7b, K7c, the sage
    pre-pass (its codes against the CPU's) and K6. Cases: the dummy family's
    self-attention (1, 2, 4352, 4352, 32: 17x16x16 tokens; K2 split in 7, so
    its reduce pass runs) and cross-attention over its 16 caption slots with
    kv_lens (K2 split in 8), a ragged case with an empty row, a case with RoPE
    tables (per head, or one shared), and a long ragged case (1, 24, 16400,
    16400, 32: 16-row last tiles, kv_lens 16390, K2 unsplit; K1's and K2/K3's
    plain versions held one head at a time, K5's and K7's tiled over keys).
    The bounds count one exponential per score at the SFU's rate beside the
    bytes and the tensor products. Returns the worst errors and the records by
    case, by kernel."""
    g = torch.Generator(device="cuda").manual_seed(32)
    ang = torch.rand(4, 1000, 16, generator=g, device="cuda") * 6.3
    tables = tuple(f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    k1_err, k1 = check_k1(card, {
        "dummy_self": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_TOKENS, h=32, lens=None, rope=None),
        "dummy_cross_kv_lens": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_CAPTION, h=32,
                                    lens=[DUMMY_CAPTION], rope=None),
        "ragged_empty_row": dict(b=2, n=2, sq=1000, skv=77, h=32, lens=[50, 0], rope=None),
        "per_head_rope": dict(b=1, n=4, sq=1000, skv=1000, h=32, lens=None, rope=tables),
        "long_ragged_kv_lens": dict(b=1, n=24, sq=H32_LONG, skv=H32_LONG, h=32, lens=[H32_LONG_VALID], rope=None),
    }, phase_name="h32_kernel_checks")
    bwd_err, bwd = check_k2k3(card, {
        "dummy_self": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_TOKENS, h=32, lens=None, rope=None),
        "dummy_cross_kv_lens": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_CAPTION, h=32,
                                    lens=[DUMMY_CAPTION], rope=None),
        "ragged_empty_row": dict(b=2, n=2, sq=1000, skv=77, h=32, lens=[77, 0], rope=None),
        "shared_rope": dict(b=1, n=4, sq=1000, skv=1000, h=32, lens=None, rope="shared"),
        "long_ragged_kv_lens": dict(b=1, n=24, sq=H32_LONG, skv=H32_LONG, h=32, lens=[H32_LONG_VALID], rope=None),
    }, phase_name="h32_kernel_checks")
    # K5 and K7a/b/c (the fused-backward and forward switches' kernels on the dummy's paths).
    variant_cases = {
        "dummy_self": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_TOKENS, h=32, lens=None, rope=None),
        "dummy_cross_kv_lens": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_CAPTION, h=32,
                                    lens=[DUMMY_CAPTION], rope=None),
        "ragged_empty_row": dict(b=2, n=2, sq=1000, skv=77, h=32, lens=[77, 0], rope=None),
        "shared_rope": dict(b=1, n=4, sq=1000, skv=1000, h=32, lens=None, rope="shared"),
        "long_ragged_kv_lens": dict(b=1, n=24, sq=H32_LONG, skv=H32_LONG, h=32, lens=[H32_LONG_VALID], rope=None),
    }
    k5_err, k5 = check_k5(card, variant_cases, phase_name="h32_kernel_checks")
    k7_err, k7 = check_k7(card, variant_cases, phase_name="h32_kernel_checks")
    # The sage pre-pass and K6 (the dummy's serving path under `--attn_provider sage`).
    k6_err, prep_err, k6 = check_k6(card, {
        "dummy_self": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_TOKENS, h=32, lens=None, rope=False),
        "dummy_cross_kv_lens": dict(b=1, n=DUMMY_HEADS, sq=DUMMY_TOKENS, skv=DUMMY_CAPTION, h=32,
                                    lens=[DUMMY_CAPTION], rope=False),
        "ragged_empty_row": dict(b=2, n=4, sq=1000, skv=77, h=32, lens=[77, 0], rope=False),
        "per_head_rope": dict(b=1, n=4, sq=1000, skv=1000, h=32, lens=None, rope=tables),
        "long_ragged_kv_lens": dict(b=1, n=24, sq=H32_LONG, skv=H32_LONG, h=32, lens=[H32_LONG_VALID], rope=False),
    }, phase_name="h32_kernel_checks")
    return dict(k1=(k1_err, k1), bwd=(bwd_err, bwd), k5=(k5_err, k5), k7=(k7_err, k7), k6=(k6_err, prep_err, k6))


def check_cogvideox_kernels(card):
    """K1 and the pre-pass at CogVideoX's joint self-attention (1, 48, 30466,
    30466, 64: K1's last 192-row q block holds 130 rows, its last kv tile 2)
    and at the CFG batch (2, ...), with the tables, against their plain
    version head by head; the pre-pass, K2 and K3 at the training shape
    against `flash_backward_reference` head by head (48 heads x 239 kv tiles
    = 11,472 CTAs: no split, no reduce pass; the last 128-row tile of K2's kv
    loop and K3's q loop holds 2 rows). Returns the worst errors and the
    records by case."""
    k1_err, k1 = check_k1_wan(card, {"cogvideox_joint_self_tables": (1, COGVIDEOX_HEADS, cogvideox_tables),
                                     "cogvideox_joint_self_tables_b2": (2, COGVIDEOX_HEADS, cogvideox_tables)},
                              phase_name="cogvideox_kernel_checks")
    bwd_err, bwd = check_k2k3(card, {"cogvideox_joint_self_tables": dict(
        b=1, n=COGVIDEOX_HEADS, sq=COGVIDEOX_TOKENS, skv=COGVIDEOX_TOKENS, h=64, lens=None, rope="cogvideox")},
        phase_name="cogvideox_kernel_checks")
    return k1_err, k1, bwd_err, bwd


def cogvideox_run_data(root):
    """COGVIDEOX_RUN_VIDEOS seeded videos at the example's 81x480x768 bucket
    (mp4v, smooth colour blobs), their `metadata.csv` with PIKA_CRUSH captions,
    the example's training.json pointing at them, and its validation.json's
    first prompt at 81x480x768 with 2 denoising steps. Returns (training.json,
    validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    frames, height, width = COGVIDEOX_BUCKET
    rng = np.random.RandomState(16)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(COGVIDEOX_RUN_VIDEOS):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25, (width, height))
            coarse = (rng.rand(frames, height // 32, width // 32, 3) * 255).astype(np.uint8)
            for frame in coarse:
                writer.write(cv2.resize(frame, (width, height), interpolation=cv2.INTER_LINEAR))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4",
                        "caption": f"PIKA_CRUSH A hydraulic press flattens toy number {i} slowly."})
    training = json.loads((COGVIDEOX_EXAMPLE / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((COGVIDEOX_EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2)]  # the first prompt
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json"


@contextlib.contextmanager
def recorded_loss_weights():
    """Record the loss weights the trainer forms each step, and the alpha-bar
    values they came from (DDIM) or None (flow matching)."""
    from finetrainers_tpu_torch.trainer.sft_trainer import trainer as sft

    fn, seen = sft.compute_loss_weighting, []

    def recording(scheme, sigmas=None, alphas=None):
        weights = fn(scheme, sigmas=sigmas, alphas=alphas)
        seen.append(dict(alphas=None if alphas is None else alphas.tolist(), weights=weights.tolist()))
        return weights

    sft.compute_loss_weighting = recording
    try:
        yield seen
    finally:
        sft.compute_loss_weighting = fn


def cogvideox_run(card):
    """The crush_smol_lora example's run through
    `finetrainers_tpu_torch.train.main` with its train.sh flags on one card
    (precompute once, `transformer:auto`, slicing and tiling, rank 32, the
    example's AdamW, logit-normal weighting, which DDIM ignores, bf16), with
    COGVIDEOX_RUN_POLICY for the example's "ops" (which does not fit one card
    at this size), from 2 videos on disk at its own 81x480x768 bucket (30,466
    tokens): 3 steps, then the final validation from the exported adapter in
    a fresh model (the example's first prompt, 2 DDIM steps of 50, CFG in one
    batch of 2). Each step's seconds, launches, reduce passes, peak memory
    and DDIM loss weights 1 / (1 - alpha_bar[t]), model TFLOP/s by
    floor_bench's joint formula with the policy's remat factor, precompute
    seconds per item, whether the VAE ran in pieces, the validation's seconds
    and launches; the exported adapter reloaded into a fresh model must give
    the trained model's forward bit for bit; the run's last step profiled. The
    transformer runs at full width cut to COGVIDEOX_RUN_BLOCKS of 42 blocks.
    Returns the run's launches, reduce passes, the adapter's directory and
    the in-step times."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models import autoencoders
    from finetrainers_tpu_torch.models.cogvideox import COGVIDEOX_5B_CONFIG

    t0 = time.perf_counter()
    training_json, validation_json = cogvideox_run_data(SMOKE_DIR / "cogvideox_run_data")
    data_s = time.perf_counter() - t0
    out_dir = SMOKE_DIR / "cogvideox_run"
    argv = train_sh_argv(COGVIDEOX_EXAMPLE, dataset_config=training_json, validation_dataset_file=validation_json,
                         output_dir=out_dir, report_to="jsonl", train_steps=COGVIDEOX_RUN_STEPS,
                         precomputation_items=COGVIDEOX_RUN_VIDEOS, gradient_checkpointing_type=COGVIDEOX_RUN_POLICY)
    with vae_pieces_seen() as vae, recorded_loss_weights() as weights, \
            counted_run(profile_step=COGVIDEOX_RUN_STEPS) as rec:
        trainer = train_cli.main(argv, transformer_config=dict(COGVIDEOX_5B_CONFIG, num_layers=COGVIDEOX_RUN_BLOCKS))
    steps, validations, prof = rec["steps"], rec["validations"], rec["profile"]
    module = trainer.transformer.module
    base_params = sum(p.numel() for n, p in module.named_parameters() if n not in trainer._trainable)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    block_params = sum(p.numel() for n, p in module.transformer_blocks[0].named_parameters() if ".lora_" not in n)
    scheduler = trainer.scheduler
    # The published model less the blocks cut away, each block's LoRA factors the published share.
    shape_ok = (base_params == COGVIDEOX_PARAMS - (COGVIDEOX_LAYERS - COGVIDEOX_RUN_BLOCKS) * block_params
                and lora_params == COGVIDEOX_LORA_PARAMS // COGVIDEOX_LAYERS * COGVIDEOX_RUN_BLOCKS
                and len(module.transformer_blocks) == COGVIDEOX_RUN_BLOCKS
                and module.gradient_checkpointing == COGVIDEOX_RUN_POLICY
                and type(scheduler).__name__ == "CogVideoXDDIMScheduler"
                and trainer.attn_provider_training == {"transformer": "auto"})
    # Each step's weight is 1 / (1 - alpha_bar[t]) of a value of the DDIM table.
    table = set(scheduler.alphas_cumprod.tolist())
    weights_ok = len(weights) == COGVIDEOX_RUN_STEPS and all(
        w["alphas"] is not None and all(a in table for a in w["alphas"])
        and np.allclose(w["weights"], 1.0 / (1.0 - np.asarray(w["alphas"], np.float32)), rtol=1e-6, atol=0)
        for w in weights)
    spec = trainer.model_specification
    precomputed = out_dir / "precomputed" / PRECOMPUTED_DIR_NAME
    items = [dict(np.load(precomputed / f"{kind}-0.npz")) for kind in ("condition", "latent")]
    latent_shape = list(items[1]["latents"].shape)
    batch = to_device((spec.collate_conditions([items[0]]), spec.collate_latents([items[1]])), torch.device("cuda"))
    # The exported adapter in a fresh model (the final validation's path) against the trained model, on 3 latent
    # frames of the bucket's 60x96 latents (4546 tokens).
    fresh = trainer._load_exported_transformer()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 3, 16, 60, 96), generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        outs = [m(x, batch[0]["encoder_hidden_states"], torch.tensor([500.0], device="cuda"))
                for m in (fresh.module, module)]
    reload_bit_equal = bool(torch.equal(*outs)) and bool(torch.isfinite(outs[0]).all())
    del fresh, outs, x, trainer, module, spec, batch, scheduler
    freed_gb = _free_cuda()

    log = [json.loads(line) for line in (out_dir / "logs" / "finetrainers-tpu-cogvideox.jsonl").read_text()
           .splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    adapter = out_dir / "lora_weights" / f"{COGVIDEOX_RUN_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    videos = sorted((out_dir / "validation").rglob("*.mp4"))
    # A step under "ops_attn": K4's outputs saved, so K1 runs in the forward only, the pre-pass before each forward
    # and each backward, K2 and K3 in each backward; 48 heads x 239 kv tiles = 11,472 CTAs, so K2's q loop is not
    # split and no reduce pass runs. Under "full" K1 and the pre-pass run once more in the recompute.
    recompute = 1 if COGVIDEOX_RUN_POLICY == "full" else 0
    step_want = dict(k1=(1 + recompute) * COGVIDEOX_RUN_BLOCKS, prep=(2 + recompute) * COGVIDEOX_RUN_BLOCKS,
                     k2=COGVIDEOX_RUN_BLOCKS, k3=COGVIDEOX_RUN_BLOCKS)
    want = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    steps_ok = all(st["launches"] == want and st["reduce"] == 0 for st in steps)
    # 1 request x 2 DDIM steps, CFG in one batch of 2.
    validation_want = {"k1": 2 * COGVIDEOX_RUN_BLOCKS, "prep": 2 * COGVIDEOX_RUN_BLOCKS}
    validations_ok = (len(validations) == 1 and validations[0]["final"]
                      and validations[0]["launches"] == validation_want)
    d = COGVIDEOX_HEADS * 64
    per_layer = joint_train_step_flops(1, d, COGVIDEOX_RANK, 0.0, B=1, S=COGVIDEOX_TOKENS) / 2.0
    remat = {"full": 1.0, "ops_attn": 1.0 - 2 * 2 * COGVIDEOX_TOKENS**2 * d / per_layer}.get(COGVIDEOX_RUN_POLICY, 0.0)
    flops = joint_train_step_flops(COGVIDEOX_RUN_BLOCKS, d, COGVIDEOX_RANK, remat, B=1, S=COGVIDEOX_TOKENS)
    median_s = statistics.median([st["seconds"] for st in steps[1:] if not st["profiled"]])  # step 2
    in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep", "k2", "k3")}
    phase("cogvideox_run", card=card, entry="python -m finetrainers_tpu_torch.train", argv=[str(a) for a in argv],
          policy_note=f"{COGVIDEOX_RUN_POLICY} for the example's ops, which does not fit one card at this bucket",
          bucket=list(COGVIDEOX_BUCKET), tokens=COGVIDEOX_TOKENS, latents_shape=latent_shape,
          blocks=COGVIDEOX_RUN_BLOCKS, blocks_note=f"cut from {COGVIDEOX_LAYERS} at full width",
          published_shape=shape_ok, base_params=base_params, lora_params=lora_params, data_write_s=data_s,
          precompute_s=precompute_s, precompute_s_per_item=precompute_s / COGVIDEOX_RUN_VIDEOS, peaks_gb=rec["peaks"],
          step_seconds=[st["seconds"] for st in steps], median_step_s_2_to_3=median_s,
          step_peaks_gb=[st["peak_gb"] for st in steps], step_launches=steps[0]["launches"],
          step_reduce_passes=[st["reduce"] for st in steps], step_launches_all_exact=steps_ok,
          ddim_loss_weights=weights, ddim_weights_ok=weights_ok,
          remat_factor=remat, model_flops_per_step=flops, model_tflops=flops / median_s / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, losses=losses, validations=validations,
          validations_launches_exact=validations_ok, validation_videos=[str(v.relative_to(SMOKE_DIR)) for v in videos],
          vae_max_elements=vae["max_elements"], vae_split_elements=autoencoders.SPLIT_ELEMENTS,
          vae_split=vae["max_elements"] > autoencoders.SPLIT_ELEMENTS, run_s=rec["run_s"], launches=rec["launches"],
          reduce_passes=rec["reduce"], export=str(adapter.relative_to(SMOKE_DIR.parent.parent)),
          export_keys=len(state), export_lora_config=config, reload_forward_bit_equal=reload_bit_equal,
          memory_after_free_gb=freed_gb)
    phase("cogvideox_run_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (shape_ok and steps_ok and validations_ok and weights_ok and reload_bit_equal
            and len(steps) == COGVIDEOX_RUN_STEPS and len(losses) == COGVIDEOX_RUN_STEPS and all(np.isfinite(losses))
            and len(state) == 2 * 6 * COGVIDEOX_RUN_BLOCKS and config.get("r") == COGVIDEOX_RANK
            and latent_shape == [1, 21, 32, 60, 96] and len(videos) == 1 and rec["reduce"] == 0):
        raise AssertionError("the crush_smol_lora CogVideoX example's run failed its checks")
    del state
    return dict(launches=rec["launches"], reduce=rec["reduce"], adapter=adapter, in_step=in_step)


def cogvideox_serve(card, adapter):
    """One 81x480x768 text-to-video request of full-width CogVideoX-5B through
    the port's runner, `inference.main`, with cogvideox_text_to_video.sh's
    flags (`--attn_provider flash`, slicing and tiling, bf16, its request
    file cut to 2 DDIM steps of 50), the runner's guidance 5.0 (CFG in one
    batch of 2) and the adapter `cogvideox_run` exported. The VAE decode, each
    denoise step and the request are timed by synced wrappers; the video must
    be finite, (81, 480, 768, 3) uint8, every LoRA factor of the served model
    the adapter's, K1 and the pre-pass once a block and step (the run's
    COGVIDEOX_RUN_BLOCKS blocks) and no other kernel. Then one denoise step
    profiled."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.data.utils import load_video
    from finetrainers_tpu_torch.models import autoencoders
    from finetrainers_tpu_torch.models.autoencoders import AutoencoderKL3D
    from finetrainers_tpu_torch.models.cogvideox import COGVIDEOX_5B_CONFIG, CogVideoXPipeline

    out_dir = SMOKE_DIR / "cogvideox_serve"
    out_dir.mkdir(parents=True, exist_ok=True)
    requests = json.loads((COGVIDEOX_SERVE_EXAMPLE / "dummy_text_to_video.json").read_text())
    requests["data"] = [dict(row, num_inference_steps=COGVIDEOX_SERVE_STEPS) for row in requests["data"]]
    (out_dir / "requests.json").write_text(json.dumps(requests))
    argv = train_sh_argv(COGVIDEOX_SERVE_EXAMPLE, script="cogvideox_text_to_video.sh",
                         single_card=["--dp_degree", "1", "--dp_shards", "1", "--cp_degree", "1", "--tp_degree", "1"],
                         dataset_file=out_dir / "requests.json", output_dir=out_dir, lora_weights=adapter)
    frames, height, width = COGVIDEOX_BUCKET
    seconds, facts, last = {"decode": [], "step": [], "request": []}, {}, []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    wrapped = ((AutoencoderKL3D, "decode"), (CogVideoXPipeline, "denoise_step"), (CogVideoXPipeline, "__call__"))
    originals = {name: getattr(cls, name) for cls, name in wrapped}
    request = timed("request", originals["__call__"])
    step = timed("step", originals["denoise_step"])

    def call(self, *args, **kwargs):
        facts["scheduler"] = type(self.scheduler).__name__
        facts["guidance_scale"] = kwargs.get("guidance_scale")
        facts["vae_slicing_tiling"] = [self.vae.use_slicing, self.vae.use_tiling]
        params = dict(self.transformer.module.named_parameters())
        adapter_state, _ = load_lora_weights(str(adapter))
        facts["lora_factors"] = len(adapter_state)
        facts["lora_loaded"] = all(bool(torch.equal(params[key[len("transformer."):]].detach(),
                                                    value.to(params[key[len("transformer."):]].device)))
                                   for key, value in adapter_state.items())
        facts["lora_b_nonzero"] = all(bool(adapter_state[f"transformer.{name}.lora_B.weight"].any()) for name in (
            "transformer_blocks.0.attn1.to_q", f"transformer_blocks.{COGVIDEOX_RUN_BLOCKS - 1}.ff.net.2"))
        del adapter_state
        video = request(self, *args, **kwargs)
        facts["video_shape"], facts["video_dtype"] = list(video.shape), str(video.dtype)
        return video

    def denoise(self, *args, **kwargs):
        last[:] = [self, args, kwargs]
        return step(self, *args, **kwargs)

    AutoencoderKL3D.decode = timed("decode", originals["decode"])
    CogVideoXPipeline.denoise_step, CogVideoXPipeline.__call__ = denoise, call
    try:
        with vae_pieces_seen() as vae:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            paths = inference.main([str(a) for a in argv],
                                   transformer_config=dict(COGVIDEOX_5B_CONFIG, num_layers=COGVIDEOX_RUN_BLOCKS))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches, peak_gb = _counts(), torch.cuda.max_memory_allocated() / 1e9
    finally:
        for cls, name in wrapped:
            setattr(cls, name, originals[name])
    with torch.inference_mode(), attention_provider("flash"):
        prof = profile_device(lambda: originals["denoise_step"](last[0], *last[1], **last[2]))
    del last[:]
    written = load_video(paths[0], to_float=False)
    expected = {k_: COGVIDEOX_RUN_BLOCKS * COGVIDEOX_SERVE_STEPS if k_ in ("k1", "prep") else 0 for k_ in launches}
    in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep")}
    phase("cogvideox_serve", card=card, entry="python -m finetrainers_tpu_torch.inference",
          argv=[str(a) for a in argv[:-2]], steps=COGVIDEOX_SERVE_STEPS, steps_note="cut from the request's 50",
          blocks=COGVIDEOX_RUN_BLOCKS,
          tokens=COGVIDEOX_TOKENS, text_tokens=COGVIDEOX_TEXT, request_s=seconds["request"], step_s=seconds["step"],
          vae_decode_s=seconds["decode"], main_wall_s=wall_s, peak_memory_gb=peak_gb, launches=launches,
          launches_expected=expected, vae_max_elements=vae["max_elements"],
          vae_split_elements=autoencoders.SPLIT_ELEMENTS, vae_split=vae["max_elements"] > autoencoders.SPLIT_ELEMENTS,
          written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent)) for p in paths],
          written_shape=list(written.shape), **facts)
    phase("cogvideox_serve_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (facts.get("video_shape") == [frames, height, width, 3] and facts.get("video_dtype") == "uint8"
            and facts.get("scheduler") == "CogVideoXDDIMScheduler" and facts.get("guidance_scale") == 5.0
            and facts.get("vae_slicing_tiling") == [True, True] and facts.get("lora_loaded")
            and facts.get("lora_b_nonzero") and facts.get("lora_factors") == 2 * 6 * COGVIDEOX_RUN_BLOCKS
            and launches == expected and len(seconds["step"]) == COGVIDEOX_SERVE_STEPS and len(seconds["decode"]) == 1
            and list(written.shape) == [frames, height, width, 3] and paths[0].endswith(".mp4")):
        raise AssertionError("CogVideoX serving through the runner failed its checks")
    phase("cogvideox_serve_freed", memory_allocated_gb=_free_cuda())
    return launches, in_step


def dummy_run_data(root):
    """4 seeded videos at the dummy run's 17x256x256 bucket (mp4v, smooth
    colour blobs) written with cv2, their `metadata.csv`, a training.json
    bucketing them there and a validation.json with one prompt at the bucket,
    2 denoising steps. Returns (training.json, validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    frames, height, width = DUMMY_BUCKET
    rng = np.random.RandomState(17)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(DUMMY_RUN_VIDEOS):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (width, height))
            coarse = (rng.rand(frames, height // 32, width // 32, 3) * 255).astype(np.uint8)
            for frame in coarse:
                writer.write(cv2.resize(frame, (width, height), interpolation=cv2.INTER_LINEAR))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"a red ball rolls past box {i}"})
    (root / "training.json").write_text(json.dumps({"datasets": [dict(
        data_root=str(root), dataset_type="video", video_resolution_buckets=[list(DUMMY_BUCKET)])]}))
    (root / "validation.json").write_text(json.dumps({"data": [dict(
        caption="a red ball rolls", num_inference_steps=2, num_frames=frames, height=height, width=width)]}))
    return root / "training.json", root / "validation.json"


def dummy_argv(training_json, validation_json, out_dir, training_type, steps, *extra):
    """`python -m finetrainers_tpu_torch.train` flags of a dummy run on one card."""
    return ["--model_name", "dummy", "--pretrained_model_name_or_path", "dummy", "--training_type", training_type,
            "--dataset_config", str(training_json), "--validation_dataset_file", str(validation_json),
            "--validation_steps", "1000", "--output_dir", str(out_dir), "--train_steps", str(steps),
            "--checkpointing_steps", str(steps), "--enable_precomputation", "--precomputation_items",
            str(DUMMY_RUN_VIDEOS), "--report_to", "jsonl", "--tracker_name", "finetrainers-tpu-dummy", "--lr", "1e-3",
            "--seed", "0", *extra]


# The dummy LoRA run repeated under each kernel switch, by run name.
DUMMY_SWITCH_RUNS = {"lora_fused_bwd": "FINETRAINERS_FLASH_FUSED_BWD", "lora_two_pass": "FINETRAINERS_FLASH_TWOPASS",
                     "lora_skew": "FINETRAINERS_FLASH_SKEW", "lora_two_level": "FINETRAINERS_FLASH_TWOLEVEL"}


def dummy_launches(sw=None):
    """A dummy run's launches under switch `sw` (JAX's gates: the dummy's
    calls carry no RoPE tables, no causal flag and no mask, so every switch
    takes them): (per train step, per final validation of 2 steps, K2 reduce
    passes per step). A step runs 2 forwards and 2 backwards a block
    (self-attention, cross-attention over the caption slots); the pre-pass
    runs before each forward but K7b's and before each backward."""
    fwd = {"FINETRAINERS_FLASH_TWOPASS": "k7a", "FINETRAINERS_FLASH_SKEW": "k7b",
           "FINETRAINERS_FLASH_TWOLEVEL": "k7c"}.get(sw, "k1")
    preps = 2 if fwd == "k7b" else 4
    fused = sw == "FINETRAINERS_FLASH_FUSED_BWD"
    step = {fwd: 2 * DUMMY_LAYERS, "prep": preps * DUMMY_LAYERS,
            **(dict(k5=2 * DUMMY_LAYERS, k5_emit=2 * DUMMY_LAYERS) if fused
               else dict(k2=2 * DUMMY_LAYERS, k3=2 * DUMMY_LAYERS))}
    validation = {fwd: 2 * 2 * DUMMY_LAYERS, **({} if fwd == "k7b" else {"prep": 2 * 2 * DUMMY_LAYERS})}
    return step, validation, 0 if fused else 2 * DUMMY_LAYERS


def dummy_run(card):
    """The dummy family at its own width (dim 64 in 2 heads of 32, 2 blocks)
    through `finetrainers_tpu_torch.train.main` on the card, from 4 videos on
    disk at 17x256x256 (17 x 16 x 16 = 4352 tokens): a LoRA run (rank 16, 4
    steps, the final validation from the exported adapter, 2 steps) and a
    full-finetune run under `adamw-bnb-8bit` (3 steps). Each step launches, at
    head dim 32, K1 twice per block (self-attention and cross-attention over
    the 16 caption slots), the pre-pass four times, K2 and K3 twice, and K2's
    reduce pass with each K2 (2 heads x 34 kv tiles and 2 x 1 tiles are fewer
    than the SMs, so both q loops are split); the validation 2 K1 and 2 pre-pass
    launches per block and step. In the full-finetune run every parameter of
    at least 4096 elements (the feed-forward kernels, 64 x 256, among them)
    keeps int8 moments. The LoRA run is repeated under `--attn_provider_training
    transformer:flash_varlen`, which takes the dummy's `kv_lens` calls to K1
    as `auto` does: its losses must be bit-equal; and under each kernel switch
    (DUMMY_SWITCH_RUNS), whose kernels take the dummy's calls as JAX's gates
    send them: FINETRAINERS_FLASH_FUSED_BWD K5 and its dq emit for every
    backward (no K2 reduce pass), FINETRAINERS_FLASH_TWOPASS and _TWOLEVEL K7a
    and K7c for every forward after the pre-pass, FINETRAINERS_FLASH_SKEW K7b
    for every forward without it (the dummy has no RoPE tables), in the steps
    and the validation alike; each run's launches exact, no library attention
    kernel in its traced second step, and its losses within
    VARIANT_LOSS_REL_TOL of the default run's (the fused backward's first
    loss, a forward of the same weights, bit-equal). Returns the LoRA run's
    adapter and the runs' launches."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.optim8bit import Adam8bit

    training_json, validation_json = dummy_run_data(SMOKE_DIR / "dummy_run_data")
    records = {}
    lora_flags = ("--rank", str(DUMMY_RANK), "--lora_alpha", str(DUMMY_RANK))
    runs = [("lora", None, "lora", DUMMY_RUN_STEPS, lora_flags),
            ("lora_flash_varlen", None, "lora", DUMMY_RUN_STEPS,
             (*lora_flags, "--attn_provider_training", "transformer:flash_varlen")),
            ("full_finetune_adamw_8bit", None, "full-finetune", DUMMY_FULL_STEPS, ("--optimizer", "adamw-bnb-8bit"))]
    runs += [(name, sw, "lora", DUMMY_RUN_STEPS, lora_flags) for name, sw in DUMMY_SWITCH_RUNS.items()]
    for name, sw, training_type, steps, extra in runs:
        step_want, validation_want, reduce_want = dummy_launches(sw)
        want = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
        out_dir = SMOKE_DIR / f"dummy_{name}"
        argv = dummy_argv(training_json, validation_json, out_dir, training_type, steps, *extra)
        with counted_run(profile_step=2 if sw else None) as rec, switch(sw):  # a switched run's step 2 traced
            trainer = train_cli.main(argv)
        steps_rec, validations = rec["steps"], rec["validations"]
        module = trainer.transformer.module
        log = [json.loads(line) for line in (out_dir / "logs" / "finetrainers-tpu-dummy.jsonl").read_text()
               .splitlines()]
        losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
        videos = sorted((out_dir / "validation").rglob("*.mp4"))
        facts = dict(heads=module.blocks[0].attn1.num_heads, head_dim=module.blocks[0].attn1.head_dim,
                     blocks=len(module.blocks), params=sum(p.numel() for p in module.parameters()),
                     trained=sum(p.numel() for p in trainer._trainable.values()))
        eight_bit = None
        if training_type != "lora":
            inner = trainer.optimizer.inner
            params = dict(module.named_parameters())
            eight_bit = {n: dict(codes=str(inner.state[p]["mu_codes"].dtype), rows=inner.state[p]["mu_scales"].numel(),
                                 nonzero=bool(inner.state[p]["mu_codes"].any()))
                         for n, p in params.items() if isinstance(inner, Adam8bit) and "mu_codes" in inner.state[p]}
            facts.update(optimizer=type(inner).__name__, moment_bytes=inner.state_bytes(),
                         fp32_moment_bytes=8 * sum(p.numel() for p in params.values()))
        steps_ok = all(st["launches"] == want and st["reduce"] == reduce_want for st in steps_rec)
        validations_ok = (len(validations) == 1 and validations[0]["final"]
                          and validations[0]["launches"] == validation_want)
        # The same LoRA run under `flash_varlen`, which takes the dummy's kv_lens calls to K1 as `auto` does.
        losses_equal_default = None if name != "lora_flash_varlen" else losses == records["lora"]["losses"]
        switch_losses = None
        if sw is not None:  # the same LoRA run under a kernel switch
            default = records["lora"]["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, default)]
            library = rec["profile"]["library_attention"]
            switch_losses = dict(switch=sw, default_losses=default, rel_diff=rel, bound=VARIANT_LOSS_REL_TOL,
                                 bit_equal=losses == default, first_bit_equal=losses[:1] == default[:1],
                                 traced_step_library_attention=library,
                                 ok=len(rel) == len(default) and max(rel) <= VARIANT_LOSS_REL_TOL and not library
                                 and (sw != "FINETRAINERS_FLASH_FUSED_BWD" or losses[:1] == default[:1]))
        phase("dummy_run", card=card, run=name, entry="python -m finetrainers_tpu_torch.train",
              argv=[str(a) for a in argv], bucket=list(DUMMY_BUCKET), tokens=DUMMY_TOKENS, **facts,
              step_seconds=[st["seconds"] for st in steps_rec], step_peaks_gb=[st["peak_gb"] for st in steps_rec],
              step_launches=steps_rec[0]["launches"], step_reduce_passes=[st["reduce"] for st in steps_rec],
              step_launches_all_exact=steps_ok, losses=losses, validations=validations,
              validations_launches_exact=validations_ok, eight_bit_moments=eight_bit, run_s=rec["run_s"],
              launches=rec["launches"], reduce_passes=rec["reduce"], losses_bit_equal_to_default=losses_equal_default,
              under_switch=switch_losses)
        ff_8bit = eight_bit is None or all(
            eight_bit.get(f"blocks.{i}.ff.{layer}.weight", {}).get("nonzero") for i in range(DUMMY_LAYERS)
            for layer in ("proj_in", "proj_out"))
        if not (steps_ok and validations_ok and len(steps_rec) == steps and len(losses) == steps
                and all(np.isfinite(losses)) and len(videos) == 1 and ff_8bit
                and (facts["heads"], facts["head_dim"], facts["blocks"]) == (DUMMY_HEADS, 32, DUMMY_LAYERS)
                and losses_equal_default is not False and (switch_losses is None or switch_losses["ok"])):
            raise AssertionError(f"the dummy {name} run failed its checks")
        records[name] = dict(launches=rec["launches"], reduce=rec["reduce"],
                             step_launches=steps_rec[0]["launches"], losses=losses)
        del trainer, module
        _free_cuda()
    return dict(records, adapter=SMOKE_DIR / "dummy_lora" / "lora_weights" / f"{DUMMY_RUN_STEPS:06d}")


def dummy_serve(card, adapter):
    """One 17x256x256 text-to-video request of the dummy family through the
    runner, `inference.main`, with the LoRA run's adapter: 4 Euler steps of K1
    twice per block and step at head dim 32 (no CFG), the VAE decode, a
    finite (17, 256, 256, 3) video written as .mp4; then the same request
    under `--attn_provider sage`: the sage pre-pass and K6 twice per block and
    step, its video within K6_STEP_REL_L2_TOL (relative L2 over the written
    frames) of the first. Returns the requests' launches by provider."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.data.utils import load_video

    out_dir = SMOKE_DIR / "dummy_serve"
    frames, height, width = DUMMY_BUCKET
    argv = ["--model_name", "dummy", "--pretrained_model_name_or_path", "dummy", "--inference_type", "text_to_video",
            "--prompt", "a red ball rolls", "--num_frames", str(frames), "--height", str(height), "--width", str(width),
            "--num_inference_steps", str(DUMMY_SERVE_STEPS), "--lora_weights", str(adapter), "--output_dir",
            str(out_dir)]
    launches, videos = {}, {}
    for provider, kernels in (("auto", ("k1", "prep")), ("sage", ("k6", "sage_prep"))):
        request = argv + (["--attn_provider", "sage", "--output_dir", str(out_dir / "sage")] if provider == "sage"
                          else [])
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        paths = inference.main(request)
        torch.cuda.synchronize()
        wall_s, launches[provider] = time.perf_counter() - t0, _counts()
        videos[provider] = load_video(paths[0], to_float=False)
        expected = {k_: 2 * DUMMY_LAYERS * DUMMY_SERVE_STEPS if k_ in kernels else 0 for k_ in launches[provider]}
        vs_auto = None
        if provider == "sage":
            a, b = (torch.from_numpy(np.asarray(videos[p], np.float32)) for p in ("sage", "auto"))
            vs_auto = dict(rel_l2=rel_l2(a, b), bound=K6_STEP_REL_L2_TOL)
        phase("dummy_serve", card=card, provider=provider, entry="python -m finetrainers_tpu_torch.inference",
              argv=request, steps=DUMMY_SERVE_STEPS, tokens=DUMMY_TOKENS, main_wall_s=wall_s,
              launches=launches[provider], launches_expected=expected, video_vs_default_provider=vs_auto,
              written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent)) for p in paths],
              written_shape=list(videos[provider].shape))
        if not (launches[provider] == expected and list(videos[provider].shape) == [frames, height, width, 3]
                and (vs_auto is None or vs_auto["rel_l2"] <= K6_STEP_REL_L2_TOL)):
            raise AssertionError(f"dummy serving through the runner under {provider} failed its checks")
    return launches


def raider_run_data(root):
    """4 seeded portrait photos at the raider_white_tarot bucket, 1280 high and
    720 wide (80-pixel colour blocks), written with cv2, their `metadata.csv`,
    the example's training.json pointing at them, and its first validation
    prompt at 1280x720 with 2 denoising steps. Returns (training.json,
    validation.json)."""
    import csv

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    height, width = RAIDER_BUCKET
    rng = np.random.RandomState(18)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(RAIDER_RUN_IMAGES):
            coarse = (rng.rand(height // 80, width // 80, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / f"card{i}.png"), cv2.resize(coarse, (width, height), interpolation=cv2.INTER_LINEAR))
            w.writerow({"file_name": f"card{i}.png", "caption": f"a trtcrd of the tower card, number {i}, tarot style"})
    training = json.loads((RAIDER_EXAMPLE / "training.json").read_text())
    training["datasets"][0]["data_root"] = str(root)
    validation = json.loads((RAIDER_EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2)]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    return root / "training.json", root / "validation.json"


def timed_forward_backward(trainer, batch):
    """`forward_backward` on `batch` with the draws of a generator seeded 7, twice
    (the second timed, synced on the host clock) -> (loss, LoRA gradients, seconds)."""
    for _ in range(2):
        trainer.optimizer.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.forward_backward(*batch, generator=torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    grads = torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])
    trainer.optimizer.zero_grad()
    return loss.item(), grads, seconds


def storage_step(argv, out_dir, storage, lora_state, batch):
    """One step's loss, LoRA gradients (no update) and forward-backward seconds
    of a fresh trainer from `argv` with the transformer's frozen weights stored
    as `storage` ("bf16": none), the given LoRA factors and the draws of a
    generator seeded 7 (`timed_forward_backward`), and its bytes by dtype."""
    from finetrainers_tpu_torch.args import BaseArgs
    from finetrainers_tpu_torch.models.cogview4 import CogView4ModelSpecification

    args = [str(a) for a in argv]
    args[args.index("--output_dir") + 1] = str(out_dir)
    i = args.index("--layerwise_upcasting_modules")
    if storage == "bf16":
        del args[i:i + 2]  # no module stored apart
    else:
        args[args.index("--layerwise_upcasting_storage_dtype") + 1] = storage
    parsed = BaseArgs().parse_args(args)
    # The spec as `train.main` builds it (its default seed), so the base weights are the run's.
    trainer = SFTTrainer(parsed, CogView4ModelSpecification(
        pretrained_model_name_or_path=parsed.pretrained_model_name_or_path, transformer_dtype=parsed.transformer_dtype,
        vae_dtype=parsed.vae_dtype, device="cuda"))
    trainer.prepare()
    with torch.no_grad():
        for name, value in lora_state.items():
            trainer._trainable[name].copy_(value)
    loss, grads, seconds = timed_forward_backward(trainer, batch)
    stored = {str(d): sum(p.numel() * p.element_size() for p in trainer.transformer.module.parameters()
                          if p.dtype == d)
              for d in {p.dtype for p in trainer.transformer.module.parameters()}}
    del trainer
    _free_cuda()
    return loss, grads, seconds, stored


def _plain_quantize_rows(v):
    """Per-row int8 codes and fp32 scales of v, as float64 (the definition of
    JAX's `quantize_rows`: absmax / 127 and v / scale as true fp32 divisions,
    rounded half to even, clipped to 127)."""
    v = v.float()
    absmax = v.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    s = absmax / torch.full_like(absmax, 127.0)
    return torch.round(v / s).clamp(-127.0, 127.0).double(), s.double()


def _elementwise_rel(got, ref):
    """max |got - ref| / |ref| over ref's nonzero entries (float64), and
    whether got is 0 wherever ref is."""
    got, nz = got.double(), ref != 0
    return ((got - ref).abs()[nz] / ref.abs()[nz]).max().item(), bool((got[~nz] == 0).all())


def check_int8_linear(card, layer, rows, seed=19):
    """`int8_linear`'s forward and dx on the card at one int8-stored layer's
    own codes and scales and `rows` tokens, against a plain float64 emulation
    of the same quantization, integer product and dequant: the activations'
    and the cotangent's codes and both int32 products equal, the outputs
    within INT8_FWD_REL_TOL and INT8_DX_REL_TOL elementwise. Two known-wrong
    controls read under the same bounds must fail them: the forward with the
    activations left unquantized, and dx with the cotangent left unquantized.
    Inputs are heavy-tailed bf16 from a seed."""
    from finetrainers_tpu_torch.ops.int8_linear import int8_linear, int_mm, quantize_rows

    wq, sw = layer.weight, layer.weight_qscale
    f, k = wq.shape
    g = torch.Generator(device=wq.device).manual_seed(seed)

    def heavy(shape):
        return (torch.randn(shape, generator=g, device=wq.device)
                * torch.randn(shape, generator=g, device=wq.device).exp()).to(torch.bfloat16)

    x, dy = heavy((rows, k)).requires_grad_(), heavy((rows, f))
    y = int8_linear(x, wq, sw)
    y.backward(dy)
    w64 = wq.double()
    xq, sx = _plain_quantize_rows(x.detach())
    acc = xq @ w64.t()  # integer sums below 2^53: exact
    ref_y = acc * sx * sw.double()[None]
    dys = dy * sw.to(torch.bfloat16)  # the cotangent as the backward forms it, in dy's dtype
    dq, sdy = _plain_quantize_rows(dys)
    acc_dx = dq @ w64
    ref_dx = acc_dx * sdy
    port_xq, port_dq = quantize_rows(x.detach())[0], quantize_rows(dys)[0]
    codes_equal = bool(torch.equal(port_xq.double(), xq)) and bool(torch.equal(port_dq.double(), dq))
    products_equal = (bool(torch.equal(int_mm(port_xq, wq).double(), acc))
                      and bool(torch.equal(int_mm(port_dq, wq.t().contiguous()).double(), acc_dx)))
    y_rel, y_zeros = _elementwise_rel(y.detach(), ref_y)
    dx_rel, dx_zeros = _elementwise_rel(x.grad, ref_dx)
    deq = w64 * sw.double()[:, None]
    ctrl_y_rel = _elementwise_rel((x.detach().double() @ deq.t()).to(torch.bfloat16), ref_y)[0]
    ctrl_dx_rel = _elementwise_rel((dys.double() @ w64).to(torch.bfloat16), ref_dx)[0]
    out = dict(card=card, shape=[rows, k, f], codes_equal=codes_equal, int32_products_equal=products_equal,
               fwd_rel_max=y_rel, fwd_rel_tol=INT8_FWD_REL_TOL, dx_rel_max=dx_rel, dx_rel_tol=INT8_DX_REL_TOL,
               zeros_exact=y_zeros and dx_zeros, rel_l2=dict(fwd=rel_l2(y.detach().double(), ref_y),
                                                             dx=rel_l2(x.grad.double(), ref_dx)),
               control_fwd_unquantized_x_rel_max=ctrl_y_rel, control_dx_unquantized_dy_rel_max=ctrl_dx_rel)
    out["ok"] = (codes_equal and products_equal and y_zeros and dx_zeros and y_rel <= INT8_FWD_REL_TOL
                 and dx_rel <= INT8_DX_REL_TOL and ctrl_y_rel > INT8_FWD_REL_TOL and ctrl_dx_rel > INT8_DX_REL_TOL)
    return out


def cogview4_sft_run(card):
    """CogView4-6B's raider_white_tarot SFT example through
    `finetrainers_tpu_torch.train.main` with its train.sh flags on one card
    (LoRA rank 32, "ops" remat, `transformer:auto`, slicing and tiling, the
    transformer's frozen weights stored int8 with `--layerwise_upcasting_storage_dtype
    int8`, AdamW with `constant_with_warmup`, logit-normal weighting, bf16),
    from 4 photos on disk at its own 1280x720 bucket (4624 tokens): 4 steps,
    the final validation (the example's first prompt, 2 steps of 50, CFG in
    one batch of 2) from the exported adapter. Each step's seconds, launches
    (K1 once per block, the pre-pass twice, K2 and K3 once: K4 saved under
    "ops"; no reduce pass) and the int8 GEMMs on `torch._int_mm` (the same
    count every step), peak memory, model TFLOP/s by floor_bench's joint
    formula at rank 32 under "ops", the bytes held as int8 against the same
    weights in bf16. Then, on the first precomputed item with the run's LoRA
    factors and one set of draws: the int8-stored step's loss and LoRA
    gradient against a bf16-stored step's and a float8_e4m3fn-stored step's
    (STORAGE_LOSS_REL_TOL, STORAGE_GRAD_REL_L2_TOL), a sanity bound; the
    int8 products at one frozen layer's own codes against their exact
    emulation (`check_int8_linear`), the tight check; and the exported
    adapter in a fresh model, stored int8 as the run stored it, giving the
    trained model's forward bit for bit. The run's last step is profiled.
    Returns the run's launches, the adapter's directory and the in-step times."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.ops.int8_linear import int_mm
    from finetrainers_tpu_torch.utils.int8 import apply_int8_storage

    t0 = time.perf_counter()
    training_json, validation_json = raider_run_data(SMOKE_DIR / "raider_run_data")
    data_s = time.perf_counter() - t0
    out_dir = SMOKE_DIR / "raider_run"
    argv = train_sh_argv(RAIDER_EXAMPLE, dataset_config=training_json, validation_dataset_file=validation_json,
                         output_dir=out_dir, report_to="jsonl", train_steps=RAIDER_RUN_STEPS,
                         precomputation_items=RAIDER_RUN_IMAGES)
    int_mm_per_step = []
    orig_step = SFTTrainer.train_step

    def counting_step(self, *args, **kwargs):
        before = int_mm.launches
        out = orig_step(self, *args, **kwargs)
        int_mm_per_step.append(int_mm.launches - before)
        return out

    SFTTrainer.train_step = counting_step
    try:
        with counted_run(profile_step=RAIDER_RUN_STEPS) as rec:
            trainer = train_cli.main(argv)
    finally:
        SFTTrainer.train_step = orig_step
    steps, validations, prof = rec["steps"], rec["validations"], rec["profile"]
    module = trainer.transformer.module
    int8_layers = [m for m in module.modules() if getattr(m, "weight", None) is not None
                   and m.weight.dtype == torch.int8]
    int8_bytes = sum(m.weight.numel() for m in int8_layers)
    scale_bytes = sum(m.weight_qscale.numel() * 4 for m in int8_layers)
    shape_ok = (len(module.transformer_blocks) == COGVIEW4_LAYERS and module.gradient_checkpointing == "ops"
                and module.transformer_blocks[0].attn1.to_q.weight.dtype == torch.int8
                and module.proj_out.weight.dtype == torch.bfloat16
                and trainer.attn_provider_training == {"transformer": "auto"}
                and trainer.args.layerwise_upcasting_storage_dtype == torch.int8)
    spec = trainer.model_specification
    precomputed = out_dir / "precomputed" / PRECOMPUTED_DIR_NAME
    items = [dict(np.load(precomputed / f"{kind}-0.npz")) for kind in ("condition", "latent")]
    latent_shape = list(items[1]["latents"].shape)
    batch = to_device((spec.collate_conditions([items[0]]), spec.collate_latents([items[1]])), torch.device("cuda"))
    lora_state = {name: p.detach().clone() for name, p in trainer._trainable.items()}
    compare = {"int8": timed_forward_backward(trainer, batch)}
    # The int8 products held tightly at the feed-forward's down projection (its 16384 -> 4096 codes, the run's 4624
    # tokens); the storage bounds above hold them only against another precision.
    int8_check = check_int8_linear(card, module.transformer_blocks[0].ff.net[2], RAIDER_TOKENS)
    phase("cogview4_sft_int8_linear_check", **int8_check)
    # The export reloaded into a fresh model stored int8 as the run stored it, against the trained model.
    fresh = trainer._load_exported_transformer()
    for name, param in fresh.module.named_parameters():
        param.requires_grad_(name in trainer._trainable)
    apply_int8_storage(fresh.module, trainer.args.layerwise_upcasting_skip_modules_pattern)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((1, 16, 160, 90), generator=g, device="cuda").to(torch.bfloat16)
    ehs, sizes = batch[0]["encoder_hidden_states"], batch[1]["original_size"]
    with torch.no_grad():
        outs = [m(x, ehs, torch.tensor([500.0], device="cuda"), original_size=sizes, target_size=sizes,
                  crop_coords=torch.zeros_like(sizes)) for m in (fresh.module, module)]
    reload_bit_equal = bool(torch.equal(*outs)) and bool(torch.isfinite(outs[0]).all())
    del fresh, outs, x, trainer, module, spec
    _free_cuda()
    stored_bf16 = None
    for storage in ("bf16", "float8_e4m3fn"):
        *compare[storage], stored = storage_step(argv, SMOKE_DIR / f"raider_{storage}", storage, lora_state, batch)
        stored_bf16 = stored if storage == "bf16" else stored_bf16
    loss_bf16, grads_bf16, _ = compare["bf16"]
    forward_backward_s = {storage: r[2] for storage, r in compare.items()}
    vs_bf16 = {}
    for storage in ("int8", "float8_e4m3fn"):
        loss, grads, _ = compare[storage]
        vs_bf16[storage] = dict(loss=loss, loss_rel=abs(loss - loss_bf16) / abs(loss_bf16),
                                grad_rel_l2=((grads - grads_bf16).norm() / grads_bf16.norm()).item(),
                                loss_rel_tol=STORAGE_LOSS_REL_TOL[storage],
                                grad_rel_l2_tol=STORAGE_GRAD_REL_L2_TOL[storage])
    del lora_state, batch, compare, grads_bf16
    _free_cuda()

    log = [json.loads(line) for line in (out_dir / "logs" / "finetrainers-tpu-cogview4.jsonl").read_text()
           .splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    adapter = out_dir / "lora_weights" / f"{RAIDER_RUN_STEPS:06d}"
    state, config = load_lora_weights(str(adapter))
    images = sorted((out_dir / "validation").rglob("*.png"))
    step_want = dict(k1=COGVIEW4_LAYERS, prep=2 * COGVIEW4_LAYERS, k2=COGVIEW4_LAYERS, k3=COGVIEW4_LAYERS)
    want = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    steps_ok = all(st["launches"] == want and st["reduce"] == 0 for st in steps)
    validation_want = {"k1": 2 * COGVIEW4_LAYERS, "prep": 2 * COGVIEW4_LAYERS}  # 2 steps, CFG in one batch
    validations_ok = (len(validations) == 1 and validations[0]["final"]
                      and validations[0]["launches"] == validation_want)
    median_s = statistics.median([st["seconds"] for st in steps[1:] if not st["profiled"]])
    flops = joint_train_step_flops(COGVIEW4_LAYERS, 4096, RAIDER_RANK, 0.0, B=1, S=RAIDER_TOKENS)
    in_step = {cls: _median(prof["launches"][cls]) for cls in ("k1", "prep", "k2", "k3")}
    storage_ok = all(r["loss_rel"] <= r["loss_rel_tol"] and r["grad_rel_l2"] <= r["grad_rel_l2_tol"]
                     for r in vs_bf16.values())
    phase("cogview4_sft_run", card=card, entry="python -m finetrainers_tpu_torch.train",
          argv=[str(a) for a in argv], bucket=list(RAIDER_BUCKET), tokens=RAIDER_TOKENS, latents_shape=latent_shape,
          published_shape=shape_ok, int8_layers=len(int8_layers), int8_bytes=int8_bytes, int8_scale_bytes=scale_bytes,
          same_weights_bf16_bytes=2 * int8_bytes, stored_bytes_by_dtype_bf16_run=stored_bf16, data_write_s=data_s,
          precompute_s=precompute_s, precompute_s_per_item=precompute_s / RAIDER_RUN_IMAGES, peaks_gb=rec["peaks"],
          step_seconds=[st["seconds"] for st in steps], median_step_s_2_to_3=median_s,
          step_peaks_gb=[st["peak_gb"] for st in steps], step_launches=steps[0]["launches"],
          step_int8_gemms=int_mm_per_step, step_reduce_passes=[st["reduce"] for st in steps],
          step_launches_all_exact=steps_ok, model_flops_per_step=flops, model_tflops=flops / median_s / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS, losses=losses, validations=validations,
          validations_launches_exact=validations_ok, validation_images=[str(i.relative_to(SMOKE_DIR)) for i in images],
          vs_bf16_storage=vs_bf16, bf16_loss=loss_bf16, storage_within_bounds=storage_ok,
          forward_backward_s_by_storage=forward_backward_s,
          run_s=rec["run_s"], launches=rec["launches"], reduce_passes=rec["reduce"],
          export=str(adapter.relative_to(SMOKE_DIR.parent.parent)), export_keys=len(state), export_lora_config=config,
          reload_forward_bit_equal=reload_bit_equal)
    phase("cogview4_sft_run_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"],
          ms_by_class=dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()}),
          ms_per_launch=in_step, launches={cls: len(v) for cls, v in prof["launches"].items()},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    if not (shape_ok and steps_ok and validations_ok and reload_bit_equal and storage_ok and int8_check["ok"]
            and len(steps) == RAIDER_RUN_STEPS and len(losses) == RAIDER_RUN_STEPS and all(np.isfinite(losses))
            and len(state) == 2 * 6 * COGVIEW4_LAYERS and config.get("r") == RAIDER_RANK
            and len(set(int_mm_per_step)) == 1 and int_mm_per_step[0] >= len(int8_layers)
            and latent_shape == [1, 32, 160, 90] and len(images) == 1 and rec["reduce"] == 0):
        raise AssertionError("the raider_white_tarot CogView4 example's run failed its checks")
    del state
    return dict(launches=rec["launches"], reduce=rec["reduce"], adapter=adapter, in_step=in_step,
                int8_gemms=int_mm_per_step[0])


def cogview4_sft_serve(card, adapter):
    """One 1024x1024 text-to-image request of full-width CogView4-6B through the
    runner, `inference.main`, with `--quantize_int8` and the adapter
    `cogview4_sft_run` exported (4 Euler steps of 50, the runner's guidance
    5.0 as a CFG batch of 2, `--attn_provider flash`, slicing and tiling): its
    seconds, each step's, the decode's, the peak, K1 and the pre-pass 28 times a
    step, one int8 GEMM per int8 layer and step, the LoRA factors kept in
    fp32 beside int8 base weights, a (1024, 1024, 3) PNG. Then the last denoise
    step again with the base weights in bf16 (a fresh model with the same
    adapter): its relative L2 against the int8 step within
    QUANTIZED_STEP_REL_L2_TOL."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.lora import apply_lora_to_module_params
    from finetrainers_tpu_torch.models.cogview4 import CogView4ModelSpecification, CogView4Pipeline
    from finetrainers_tpu_torch.ops.int8_linear import int_mm

    import cv2

    out_dir = SMOKE_DIR / "raider_serve"
    argv = ["--model_name", "cogview4", "--pretrained_model_name_or_path", str(SMOKE_DIR / "cogview4_checkpoint"),
            "--inference_type", "text_to_image", "--prompt", "a trtcrd of a lighthouse on a cliff at night, tarot style",
            "--height", "1024", "--width", "1024", "--num_inference_steps", str(RAIDER_SERVE_STEPS),
            "--attn_provider", "flash", "--enable_slicing", "--enable_tiling", "--seed", "31337", "--quantize_int8",
            "--lora_weights", str(adapter), "--output_dir", str(out_dir)]
    seconds, facts, last = {"step": [], "request": []}, {}, []
    originals = {attr: getattr(CogView4Pipeline, attr) for attr in ("denoise_step", "__call__")}

    def call(self, *args, **kwargs):
        module = self.transformer.module
        layers = [m for m in module.modules() if getattr(m, "weight", None) is not None]
        facts.update(int8_layers=sum(m.weight.dtype == torch.int8 for m in layers),
                     lora_fp32=all(m.lora_A.weight.dtype == torch.float32 for m in layers if getattr(m, "rank", 0)),
                     lora_rank=module.transformer_blocks[0].attn1.to_q.rank)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = originals["__call__"](self, *args, **kwargs)
        torch.cuda.synchronize()
        seconds["request"].append(time.perf_counter() - t0)
        facts["image_shape"], facts["image_dtype"] = list(image.shape), str(image.dtype)
        return image

    def denoise(self, *args, **kwargs):
        last[:] = [self, args, kwargs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals["denoise_step"](self, *args, **kwargs)
        torch.cuda.synchronize()
        seconds["step"].append(time.perf_counter() - t0)
        return out

    CogView4Pipeline.denoise_step, CogView4Pipeline.__call__ = denoise, call
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        mm_before, t0 = int_mm.launches, time.perf_counter()
        paths = inference.main(argv)
        torch.cuda.synchronize()
        wall_s, launches, peak_gb = time.perf_counter() - t0, _counts(), torch.cuda.max_memory_allocated() / 1e9
        int8_gemms = int_mm.launches - mm_before
    finally:
        for attr, fn in originals.items():
            setattr(CogView4Pipeline, attr, fn)
    pipeline, args, kwargs = last
    with torch.inference_mode(), attention_provider("flash"):
        step_int8, int8_step_ms = timed_call(lambda: originals["denoise_step"](pipeline, *args, **kwargs).float())
        spec = CogView4ModelSpecification(pretrained_model_name_or_path=str(SMOKE_DIR / "cogview4_checkpoint"),
                                          device="cuda")  # as the runner builds it
        spec.lora_rank, spec.lora_alpha = RAIDER_RANK, float(RAIDER_RANK)
        handle = spec.load_diffusion_models()["transformer"]
        state, _ = load_lora_weights(str(adapter))
        apply_lora_to_module_params(handle.module, state, key_map=spec.transformer_key_map)
        pipeline.transformer = handle
        originals["denoise_step"](pipeline, *args, **kwargs)  # the bf16 model's first step, untimed
        step_bf16, bf16_step_ms = timed_call(lambda: originals["denoise_step"](pipeline, *args, **kwargs).float())
    rel_l2 = ((step_int8 - step_bf16).norm() / step_bf16.norm()).item()
    del last[:], pipeline, handle, state, step_int8, step_bf16
    written = cv2.imread(paths[0])
    expected = {k_: COGVIEW4_LAYERS * RAIDER_SERVE_STEPS if k_ in ("k1", "prep") else 0 for k_ in _COUNTED}
    phase("cogview4_sft_serve", card=card, entry="python -m finetrainers_tpu_torch.inference", argv=argv[:-2],
          steps=RAIDER_SERVE_STEPS, steps_note="cut from the request's 50", request_s=seconds["request"],
          step_s=seconds["step"], main_wall_s=wall_s, peak_memory_gb=peak_gb, launches=launches,
          launches_expected=expected, int8_gemms=int8_gemms, **facts, step_rel_l2_vs_bf16=rel_l2,
          step_ms_int8_then_bf16=[int8_step_ms, bf16_step_ms],
          step_rel_l2_tol=QUANTIZED_STEP_REL_L2_TOL,
          written=[str(pathlib.Path(p).relative_to(SMOKE_DIR.parent.parent)) for p in paths],
          written_shape=list(written.shape) if written is not None else None)
    if not (launches == expected and facts.get("image_shape") == [1024, 1024, 3] and facts.get("lora_fp32")
            and facts.get("lora_rank") == RAIDER_RANK and facts.get("int8_layers", 0) > 0
            and int8_gemms == facts["int8_layers"] * RAIDER_SERVE_STEPS and rel_l2 <= QUANTIZED_STEP_REL_L2_TOL
            and written is not None and list(written.shape) == [1024, 1024, 3]):
        raise AssertionError("CogView4 serving under --quantize_int8 through the runner failed its checks")
    phase("cogview4_sft_serve_freed", memory_allocated_gb=_free_cuda())
    return dict(launches=launches, int8_gemms=int8_gemms)


def causal_mask(b, sq, skv, lens=None, device="cuda"):
    """(B, Sq, Skv) boolean: query i sees key j <= i (+ Skv - Sq), and with
    `lens` only keys j < lens[b] (the decoders' causal and padding mask)."""
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device).tril(skv - sq)[None].expand(b, sq, skv)
    if lens is not None:
        mask = mask & (torch.arange(skv, device=device)[None, :] < torch.tensor(lens, device=device)[:, None])[:, None]
    return mask.contiguous()


def block_sparse_mask(b, sq, skv, g):
    """A random mask over 64x64 blocks (a third of them off) with a quarter of
    the rest's keys off, all of key tile 1 off for every row (an all-zero
    tile), row 5 of batch 0 off throughout (a row with no live key), and
    ragged last tiles where Sq and Skv are not multiples of the tiles."""
    blocks = torch.rand(b, -(-sq // 64), -(-skv // 64), generator=g, device="cuda") > 1 / 3
    mask = blocks.repeat_interleave(64, 1).repeat_interleave(64, 2)[:, :sq, :skv]
    mask = mask & (torch.rand(b, sq, skv, generator=g, device="cuda") > 0.25)
    mask[:, :, 128:256] = False
    mask[0, 5] = False
    return mask.contiguous()


def k1_mask_bound(b, n, sq, skv, h, mask):
    """K1's mask branch's least time for this mask: its two products over the
    mask's set entries only, q and out once, k and v of the keys some row
    attends once, the mask's bytes and the LSE once."""
    live_keys = int(mask.any(dim=1).sum())
    return bound(4 * n * h * int(mask.sum()),
                 2 * b * n * sq * h * 2 + 2 * n * live_keys * h * 2 + mask.numel() + b * n * sq * 4)


# K1's mask branch at the towers' shapes: (name, B, N, N_kv, Sq, Skv, H, mask kind, lens).
K1_MASK_CASES = (
    ("glm_causal_gqa", 1, 32, 2, 1024, 1024, 128, "causal", None),
    ("llama_causal_padding_gqa", 2, 32, 8, 351, 351, 128, "causal", [120, 351]),
    ("clip_text_causal", 2, 12, 12, 77, 77, 64, "causal", None),
    ("block_sparse_h128", 2, 8, 8, 700, 900, 128, "sparse", None),
    ("block_sparse_h64", 2, 8, 8, 1000, 333, 64, "sparse", None),
)


def check_k1_mask(card):
    """K1's mask branch against its plain version on the card, at the text
    towers' shapes (GLM-4's 32 query heads over 2 kv heads, repeated, under a
    causal mask; Llama-3's 32 over 8 under causal and padding masks; CLIP-L
    text's causal mask at head dim 64) and random block-sparse masks with an
    all-zero key tile, a row with no live key and ragged last tiles: the
    branch alone (`flash_forward_masked_core`) against
    `flash_forward_core_reference` with the mask on the pre-pass's operands, the
    pre-pass plus the branch through `flash_attention` (the GQA repeat
    included) against `flash_attention_reference` with the mask; rows with a live
    key within K1's tolerance, rows without one exactly 0 with an LSE of
    -1e30*ln2; k and v rows of an all-zero tile filled with large values
    leave out and LSE bit-equal. Then standalone times at (1, 32, 4096, 4096,
    128) under a causal mask beside unmasked K1 and SDPA given the same
    boolean mask. Returns the worst error and the records by case."""
    g = torch.Generator(device="cuda").manual_seed(21)
    worst, records = 0.0, {}
    empty_lse = float(np.float32(-1e30 * np.log(2.0)))
    for name, b, n, n_kv, sq, skv, h, kind, lens in K1_MASK_CASES:
        q = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, skv, n_kv, h, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        mask = causal_mask(b, sq, skv, lens) if kind == "causal" else block_sparse_mask(b, sq, skv, g)
        with torch.no_grad():
            out = flash_attention(q, k, v, attn_mask=mask)
        kb, vb = (x.repeat_interleave(n // n_kv, dim=2).transpose(1, 2) for x in (k, v))
        qb = q.transpose(1, 2)
        q_s, k_r = flash_qk_prep(qb, kb, None, None, 0, h**-0.5)
        core_out, core_lse = flash_forward_masked_core(q_s, k_r, vb, mask)
        torch.cuda.synchronize()
        (ref, ref_lse), plain_ms = timed_call(lambda: flash_forward_core_reference(q_s, k_r, vb, mask=mask))
        full_ref, _ = flash_attention_reference(qb, kb, vb, mask=mask)
        live_rows = mask.any(dim=-1)  # (B, Sq)
        errs = {}
        for against, got, want, got_lse in (("plain", core_out, ref, core_lse),
                                             ("flash_attention_reference", out.transpose(1, 2), full_ref,
                                              None)):
            err = (got.float() - want.float()).abs()
            rows = live_rows[:, None, :, None].expand_as(err)
            errs[against] = dict(max_abs_err=err[rows].max().item(),
                                 err_over_max1_ref=(err / want.float().abs().clamp_min(1.0))[rows].max().item())
            if got_lse is not None:
                errs[against]["lse_max_abs_err"] = (got_lse - ref_lse).abs()[live_rows[:, None].expand_as(got_lse)].max().item()
        empty = ~live_rows
        empty_ok = bool(not core_out.transpose(1, 2)[empty].any()
                        and (core_lse.transpose(1, 2)[empty] == empty_lse).all()) if empty.any() else None
        skipped_ok = None
        if kind == "sparse":  # key tile 1 is off for every row: its k and v rows are never read
            big_k, big_v = k_r.clone(), vb.clone()
            big_k[:, :, 128:256], big_v[:, :, 128:256] = 3e4, -3e4
            big = flash_forward_masked_core(q_s, big_k, big_v, mask)
            skipped_ok = torch.equal(big[0], core_out) and torch.equal(big[1], core_lse)
        ms = cuda_ms(lambda: flash_forward_masked_core(q_s, k_r, vb, mask))  # the mask's tiles built once, cached
        tiles_ms = cuda_ms(lambda: mask_tiles(mask, h))
        attn_mask = mask[:, None]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=attn_mask))
        bound_ms, bound_by = k1_mask_bound(b, n, sq, skv, h, mask)
        _, tiles, counts = mask_tiles(mask, h)
        phase("k1_mask_check", case=name, shape=[b, n, sq, skv, h], kv_heads=n_kv, mask=kind, lens=lens,
              live_tiles=int(counts.sum()), tiles=int(counts.numel() * tiles.shape[-1]),
              vs_plain=errs["plain"], vs_flash_attention_reference=errs["flash_attention_reference"],
              empty_rows=int(empty.sum()), empty_rows_zero_and_lse=empty_ok, skipped_tile_rows_ignored=skipped_ok,
              ms=ms, mask_tiles_ms=tiles_ms, plain_ms=plain_ms, sdpa_same_mask_ms=sdpa_ms, bound_ms=bound_ms,
              bound_by=bound_by, tflops=4 * n * h * int(mask.sum()) / ms / 1e9, card=card)
        if not (all(e["err_over_max1_ref"] <= K1_TOL for e in errs.values()) and errs["plain"]["lse_max_abs_err"]
                <= LSE_TOL and empty_ok is not False and skipped_ok is not False):
            raise AssertionError(f"K1's mask branch disagrees with its plain version on {name}: {errs}, empty rows "
                                 f"{empty_ok}, skipped tile {skipped_ok}")
        worst = max(worst, errs["plain"]["max_abs_err"], errs["flash_attention_reference"]["max_abs_err"])
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, kb, vb, q_s, k_r, out, core_out, ref, full_ref
    # The long causal shape, timed only: masked against unmasked K1 and SDPA under the same boolean mask.
    b, n, s, h = 1, 32, 4096, 128
    q_s, k_r, v = (torch.randn(b, n, s, h, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    mask = causal_mask(b, s, s)
    masked_ms = cuda_ms(lambda: flash_forward_masked_core(q_s, k_r, v, mask))
    unmasked_ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v))
    attn_mask = mask[:, None]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q_s, k_r, v, attn_mask=attn_mask))
    sdpa_causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q_s, k_r, v, is_causal=True))
    tiles_ms = cuda_ms(lambda: mask_tiles(mask, h))
    bound_ms, bound_by = k1_mask_bound(b, n, s, s, h, mask)
    phase("k1_mask_long_causal", shape=[b, n, s, s, h], ms=masked_ms, unmasked_k1_ms=unmasked_ms,
          masked_over_unmasked=masked_ms / unmasked_ms, sdpa_same_mask_ms=sdpa_ms, sdpa_is_causal_ms=sdpa_causal_ms,
          mask_tiles_ms=tiles_ms, bound_ms=bound_ms, bound_by=bound_by,
          tflops=4 * n * h * int(mask.sum()) / masked_ms / 1e9, card=card)
    records["long_causal"] = dict(ms=masked_ms, plain_ms=None, library_ms=sdpa_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, unmasked_k1_ms=unmasked_ms)
    return worst, records


# The attention branches of K1, K2 and K3 (causal, segment ids, a dense mask) at the models' widths, through
# `attention_dispatch` and autograd in bf16: (name, provider, B, N, Sq, Skv, H, kind). Wan 2.1 T2V-1.3B's
# self-attention over two clips of the example's 480x832 bucket packed with `pack_sequences` (17 and 29 frames,
# 7,800 + 12,480 tokens, padded to 20,352 with -1 ids) with each clip's RoPE tables; Llama-3-8B's attention over 8 kv
# heads repeated, causal, square and with Sq < Skv; CogView4-6B's joint attention over [1024 GLM slots, 4096
# patches] with the keys of the padded GLM slots past 143 live ones masked for every query (ROADMAP.md section 3,
# finding 15's shape) and a random block-sparse mask with ragged tiles and an empty row.
BRANCH_CASES = (
    ("varlen_wan_packed", "flash_varlen", 1, 12, 20352, 20352, 128, "segment"),
    ("causal_llama", "auto", 1, 32, 4096, 4096, 128, "causal"),
    ("causal_llama_q_short", "auto", 1, 32, 1024, 4096, 128, "causal"),
    ("flex_cogview4_padded_slots", "flex", 1, 32, 5120, 5120, 128, "padded_slots"),
    ("flex_block_sparse", "flex", 1, 32, 5000, 4900, 128, "sparse"),
    # Head dim 32 at the dummy family's width (2 heads, 17x16x16 tokens): two clips packed, causal, block-sparse.
    ("varlen_dummy_packed_h32", "flash_varlen", 1, DUMMY_HEADS, DUMMY_TOKENS, DUMMY_TOKENS, 32, "segment"),
    ("causal_dummy_h32", "auto", 1, DUMMY_HEADS, DUMMY_TOKENS, DUMMY_TOKENS, 32, "causal"),
    ("flex_dummy_sparse_h32", "flex", 1, DUMMY_HEADS, DUMMY_TOKENS, DUMMY_TOKENS - 100, 32, "sparse"),
)
WAN_CLIP_FRAMES, WAN_CLIP_TOKENS = (5, 8), (7800, 12480)  # latent frames of 17 and 29 video frames, at 30 x 52
# The dummy's packed clips: 9x16x16 and 7x16x16 tokens (33 and 25 frames at 256x256; no RoPE), 256 of padding.
DUMMY_CLIP_TOKENS = (2304, 1792)
COGVIEW4_LIVE_SLOTS = 143
# The kernels of each branch, by torch.profiler name.
BRANCH_KERNELS = {"segment": "flash_fwd_segment_sm90_kernel", "causal": "flash_fwd_causal_sm90_kernel",
                  "mask": "flash_fwd_mask_sm90_kernel"}
# Library attention kernels, any of which on the branches' path fails the check.
LIBRARY_ATTENTION = ("fmha", "pytorch_flash", "efficient_attention", "cudnn", "sdpa", "flash::")


# The kernels with branches, by their `_counts()` key.
_BRANCHED = dict(k1=flash_forward, k2=flash_bwd_dkdv, k3=flash_bwd_dq, k5=flash_bwd_fused, k7a=flash_forward_twopass,
                 k7b=flash_forward_skew, k7c=flash_forward_two_level)


def _branch_counts():
    """The branch launches of K1, K2, K3, K5 and K7a/b/c besides `_counts()`, and K2's launches that ran its
    reduce pass (`k2_reduce`)."""
    return {**{f"{key}_{branch}": n for key, fn in _BRANCHED.items() for branch, n in fn.branch_launches.items()},
            "k2_reduce": flash_bwd_dkdv.reduce_launches}


def _zero_branch_counts():
    for fn in _BRANCHED.values():
        for branch in fn.branch_launches:
            fn.branch_launches[branch] = 0
    flash_bwd_dkdv.reduce_launches = 0


def branch_bounds(b, n, sq, skv, h, live):
    """K1's, K2's, K3's and K5's least times over `live` (query, key) pairs
    only: K1 (and K7a/b/c, which compute its function) 4*N*live*H operations
    against q, k, v, out and the LSE once; K2 8*N*live*H against q_s, dO, LSE,
    delta, k_r, v read and dk, dv written once; K3 6*N*live*H against q_s, dO,
    LSE, delta, k_r, v read and dq written once; K5 10*N*live*H against K2's
    bytes and its fp32 dq accumulator written once. At H=32 each also one
    exponential per live pair (`exp_bound`)."""
    q_bytes, kv_bytes, rows = b * n * sq * h * 2, b * n * skv * h * 2, b * n * sq * 4
    bounds = (bound(4 * n * live * h, 2 * q_bytes + 2 * kv_bytes + rows),
              bound(8 * n * live * h, 2 * q_bytes + 2 * kv_bytes + 2 * rows + 2 * kv_bytes),
              bound(6 * n * live * h, 3 * q_bytes + 2 * kv_bytes + 2 * rows),
              bound(10 * n * live * h, 2 * q_bytes + 2 * kv_bytes + 2 * rows + 2 * kv_bytes + 2 * q_bytes))
    return tuple(exp_bound(r, n * live) for r in bounds) if h == 32 else bounds


def _branch_inputs(name, b, n, sq, skv, h, kind, g):
    """BTNH bf16 leaves q, k, v, the upstream gradient, and the branch's inputs:
    (kwargs for `attention_dispatch`, kwargs for the plain versions, the
    (B, Sq, Skv) live pairs)."""
    q = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16)
    kv_heads = min(8, n) if kind == "causal" else n
    k, v = (torch.randn(b, skv, kv_heads, h, generator=g, device="cuda").to(torch.bfloat16)
            .repeat_interleave(n // kv_heads, dim=2) for _ in range(2))
    do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16)
    if kind == "segment" and h == 32:  # the dummy's two clips packed (it has no RoPE), -1 on the padding
        clips = [torch.arange(t, device="cuda") for t in DUMMY_CLIP_TOKENS]
        _, ids = attention_ops.pack_sequences(clips, total_len=sq)
        ids = ids.to("cuda")
        live = ids[:, :, None] == ids[:, None, :]
        return q, k, v, do, (dict(q_segment_ids=ids, kv_segment_ids=ids), dict(q_seg=ids, kv_seg=ids), live)
    if kind == "segment":  # the two clips packed, each with its own Wan tables, identity on the padding
        clips = [torch.arange(t, device="cuda") for t in WAN_CLIP_TOKENS]
        _, ids = attention_ops.pack_sequences(clips, total_len=sq)
        tables = [wan_tables((f, 30, 52)) for f in WAN_CLIP_FRAMES]
        pad = sq - sum(WAN_CLIP_TOKENS)
        cos = torch.cat([t[0] for t in tables] + [torch.ones(pad, h, device="cuda")]).contiguous()
        sin = torch.cat([t[1] for t in tables] + [torch.zeros(pad, h, device="cuda")]).contiguous()
        ids = ids.to("cuda")
        live = ids[:, :, None] == ids[:, None, :]
        return q, k, v, do, (dict(q_segment_ids=ids, kv_segment_ids=ids, rope_freqs=(cos, sin)),
                             dict(q_seg=ids, kv_seg=ids, rope=(cos[None], sin[None])), live)
    if kind == "causal":
        live = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril(skv - sq)[None]
        return q, k, v, do, (dict(is_causal=True), dict(causal=True), live)
    if kind == "padded_slots":
        mask = torch.ones(b, sq, skv, dtype=torch.bool, device="cuda")
        mask[:, :, COGVIEW4_LIVE_SLOTS:COGVIEW4_TEXT] = False
    else:
        mask = block_sparse_mask(b, sq, skv, g)
    return q, k, v, do, (dict(attn_mask=mask[:, None]), dict(mask=mask), mask)


# The switches whose kernels' branches each branch case runs (`_flash_forward`'s gates): a segment call reaches
# K7a, K7b (without RoPE tables, which gate it off) and K7c, a causal or masked one K7c only; every backward K5.
VARIANT_SWITCHES = {"segment": ("FINETRAINERS_FLASH_TWOLEVEL", "FINETRAINERS_FLASH_TWOPASS", "FINETRAINERS_FLASH_SKEW",
                                "FINETRAINERS_FLASH_FUSED_BWD"),
                    "causal": ("FINETRAINERS_FLASH_TWOLEVEL", "FINETRAINERS_FLASH_FUSED_BWD"),
                    "mask": ("FINETRAINERS_FLASH_TWOLEVEL", "FINETRAINERS_FLASH_FUSED_BWD")}
# The K7 kernels' names for torch.profiler, by branch.
VARIANT_KERNELS = {"k7a": "flash_fwd_twopass_{}_sm90_kernel", "k7b": "flash_fwd_skew_{}_sm90_kernel",
                   "k7c": "flash_fwd_two_level_{}_sm90_kernel"}


def check_variant_branches(card, c):
    """K7c's, K7a's, K7b's and K5's branches at one of `check_attention_branches`'
    cases, on its inputs (`c`), under each switch JAX sends the case's branch
    to (VARIANT_SWITCHES): through `attention_dispatch` and autograd once with
    the counts zeroed just before (exactly `switch_launches`) and once traced
    (no library attention kernel); the forward's out and LSE (`flash_forward`
    under the switch, bit-equal to K4's out) against the kernel's plain version
    within K1's tolerances on rows with a live key (rows without one exactly 0)
    and against K1's branch; K5's dq, dk and dv against its plain version and
    against K2+K3's within K2/K3's; in the padded-slot case the dead key tiles
    filled with +-3e4 leaving out and LSE (K7c), the live keys' dk and dv (K5)
    bit-equal, the dead keys' exactly 0 and dq within tolerance. The kernel
    alone on the pre-pass's operands (K7b on q and k): CUDA-event and device
    ms, the plain version's ms, the bound over the live pairs, beside K1's or
    K2+K3's branch and SDPA's times on the same case. Returns the records by
    switch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, n, sq, skv, h = c["shape"]
    branch, branches, run, leaves, do = c["branch"], c["branches"], c["run"], c["leaves"], c["do"]
    qb, kb, vb, dob = (x.detach().transpose(1, 2) for x in (*leaves, do))
    live_rows = c["live"].expand(b, sq, skv).any(-1)[:, None, :].expand(b, n, sq)
    live = int(c["live"].expand(b, sq, skv).sum())
    bounds = branch_bounds(b, n, sq, skv, h, live)
    times, empty_lse = c["times"], float(np.float32(-1e30 * np.log(2.0)))
    fwd_plain = {key: ref for key, (_, ref) in K7_KERNELS.items()}
    mask = branches["mask"]
    records, failed = {}, []
    for sw in VARIANT_SWITCHES[branch]:
        fwd = SWITCH_FORWARD[sw]
        tables = (None, None) if fwd == "k7b" else c["tables"]
        kw = {k_: v_ for k_, v_ in c["dispatch_kw"].items() if not (fwd == "k7b" and k_ == "rope_freqs")}
        want = switch_launches(sw, branch, dkdv_splits(b, n, sq, skv, torch.cuda.get_device_properties(0)
                                                       .multi_processor_count)[0])
        with switch(sw):
            torch.cuda.synchronize()
            _zero_counts()
            _zero_branch_counts()
            out, dq, dk, dv = run(leaves, kw)
            torch.cuda.synchronize()
            counts = {k_: n_ for k_, n_ in {**_counts(), **_branch_counts()}.items() if n_}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(leaves, kw)
                torch.cuda.synchronize()
            names = {evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA}
            f_out, f_lse = flash_forward(qb, kb, vb, None, *tables, None, **branches)
        library = sorted(nm for nm in names if any(t in nm.lower() for t in LIBRARY_ATTENTION))
        checks = dict(launches_exact=counts == want, no_library_kernel=not library,
                      out_equal_to_k4=bool(torch.equal(f_out, out.transpose(1, 2))))
        rec = dict(switch=sw, launches=counts, library_kernels=library)
        if fwd is not None:  # the forward variant's branch
            (ref, ref_lse), plain_ms = timed_call(lambda: fwd_plain[fwd](qb, kb, vb, None, *tables, None, **branches))
            diff = f_out.float() - ref.float()
            rec["vs_plain"] = dict(max_abs_err=diff.abs()[live_rows].max().item(),
                                   err_over_max1_ref=(diff.abs() / ref.float().abs().clamp_min(1.0))[live_rows].max()
                                   .item(), rel_l2=(diff[live_rows].norm() / ref.float()[live_rows].norm()).item(),
                                   lse_max_abs_err=(f_lse - ref_lse).abs()[live_rows].max().item())
            del diff, ref, ref_lse
            if fwd != "k7b":  # K1's branch on the same call (K7b's runs without the case's tables)
                e = (f_out.float() - c["k_out"].float()).abs()
                rec["vs_k1_branch_err_over_max1"] = (e / c["k_out"].float().abs().clamp_min(1.0))[live_rows].max().item()
                checks["equals_k1_branch"] = rec["vs_k1_branch_err_over_max1"] <= K1_TOL
                del e
            if not live_rows.all():
                checks["empty_rows_zero"] = bool(not f_out[~live_rows].any() and (f_lse[~live_rows] == empty_lse).all())
            wrapper = K7_KERNELS[fwd][0]
            if fwd == "k7b":
                alone = lambda: wrapper(qb, kb, vb, None, None, None, None, **branches)  # noqa: E731
            else:
                alone = lambda: _variant_branch(wrapper.__name__, branch, c["q_s"], c["k_r"], vb, None,  # noqa: E731
                                                branches["q_seg"], branches["kv_seg"], mask, None)
            rec.update(ms=cuda_ms(alone), device_ms=device_ms(alone, (VARIANT_KERNELS[fwd].format(branch),)),
                       plain_ms=plain_ms, bound_ms=bounds[0][0], bound_by=bounds[0][1], library_ms=times["sdpa_ms"],
                       k1_branch_ms=times["k1_ms"], k1_branch_device_ms=c["record"]["k1_device_ms"])
            ok = (rec["vs_plain"]["err_over_max1_ref"] <= K1_TOL and rec["vs_plain"]["rel_l2"] <= K1_REL_L2_TOL
                  and rec["vs_plain"]["lse_max_abs_err"] <= LSE_TOL)
        else:  # K5's branch
            (refs), plain_ms = timed_call(lambda: flash_backward_fused_reference(
                qb, kb, vb, c["k_out"], c["k_lse"], dob, None, *tables, None, None, **branches))
            grads = (dq, dk, dv)
            errs = {nm: rel_errors(got.transpose(1, 2), want_) for nm, got, want_ in zip(("dq", "dk", "dv"), grads, refs)}
            vs_k2k3 = {nm: rel_errors(got, want_) for nm, got, want_ in zip(("dq", "dk", "dv"), grads, c["grads"])}
            del refs
            rec["bwd_vs_plain"] = {nm: dict(zip(("rel_l2", "max_err_over_max_ref", "max_abs_err"), e))
                                   for nm, e in errs.items()}
            rec["bwd_vs_k2k3"] = {nm: dict(zip(("rel_l2", "max_err_over_max_ref", "max_abs_err"), e))
                                  for nm, e in vs_k2k3.items()}
            if not live_rows.all():
                checks["empty_rows_zero"] = bool(not dq.transpose(1, 2)[~live_rows].any())
            bwd_ops = (c["q_s"], c["k_r"], vb, dob, c["k_lse"].contiguous(), c["delta"], None, *tables, 0)
            alone = lambda: flash_bwd_fused(*bwd_ops, **branches)  # noqa: E731
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            k5_names = ("bwd_fused_sm90_kernel",) + (K2_KERNELS[1:] if dkdv_splits(b, n, sq, skv, sms)[0] > 1 else ())
            rec.update(ms=cuda_ms(alone), device_ms=device_ms(alone, k5_names), plain_ms=plain_ms,
                       bound_ms=bounds[3][0], bound_by=bounds[3][1], library_ms=times["sdpa_backward_ms"],
                       k2_k3_branch_ms=times["k2_ms"] + times["k3_ms"],
                       k2_k3_branch_device_ms=(c["record"]["k2_device_ms"] or 0) + (c["record"]["k3_device_ms"] or 0))
            ok = all(e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL for e in (*errs.values(), *vs_k2k3.values()))
        if c["kind"] == "padded_slots":  # the dead key tiles 2-7 (keys 256-1023) are never read
            big = [x.detach().clone() for x in leaves[1:]]
            big[0][:, 256:COGVIEW4_TEXT], big[1][:, 256:COGVIEW4_TEXT] = 3e4, -3e4
            b_leaves = [leaves[0].detach().clone().requires_grad_()] + [x.requires_grad_() for x in big]
            dead = slice(COGVIEW4_LIVE_SLOTS, COGVIEW4_TEXT)
            live_keys = torch.ones(skv, dtype=torch.bool, device="cuda")
            live_keys[dead] = False
            with switch(sw):
                b_out, b_dq, b_dk, b_dv = run(b_leaves, kw)
                _, b_lse = flash_forward(qb, big[0].transpose(1, 2), big[1].transpose(1, 2), mask=mask)
            if fwd is not None:
                checks["dead_tiles_never_read"] = bool(torch.equal(b_out, out) and torch.equal(b_lse, f_lse))
            else:
                e = rel_errors(b_dq, dq)
                checks["dead_tiles_never_read"] = bool(
                    torch.equal(b_dk[:, live_keys], dk[:, live_keys]) and torch.equal(b_dv[:, live_keys], dv[:, live_keys])
                    and not b_dk[:, dead].any() and not b_dv[:, dead].any() and e[0] <= BWD_REL_L2_TOL
                    and e[1] <= BWD_MAX_RATIO_TOL)
            del b_leaves, b_out, b_dq, b_dk, b_dv, big
        del out, dq, dk, dv, f_out, f_lse
        rec.update(checks=checks, live_pairs=live)
        phase("variant_branches", case=c["name"], branch=branch, kernel=fwd or "k5", shape=[b, n, sq, skv, h], **rec,
              card=card)
        if not (ok and all(v_ is not False for v_ in checks.values())):
            failed.append((sw, rec))
        records[sw] = rec
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"a K5 or K7 branch failed on {c['name']}: {failed}")
    return records


def check_attention_branches(card, cases=BRANCH_CASES):
    """The causal, segment and mask branches of K1, K2 and K3 on the card,
    through `attention_dispatch` and `torch.autograd` in bf16 at the models'
    widths (BRANCH_CASES): each case's forward and backward once with the
    counts zeroed just before (the pre-pass twice, the branch's K1, K2 (with
    its reduce pass where the q loop splits) and K3 once each, no other
    counted kernel, and no library attention kernel in its torch.profiler
    trace); out (elementwise and in relative L2) and the LSE against the plain
    versions within K1's tolerances on rows with a live key (rows without one
    exactly 0), and bit-equal to `flash_forward`'s, dq, dk and dv within
    K2/K3's; `flash_varlen`'s packed clips against each clip run alone through
    K1-K3 (the same tolerances); the causal branch's out against K1's mask
    branch given the same causal mask, and its CUDA-event and
    device times over the unmasked kernels' on the same inputs (about 0.5
    where the diagonal's tiles are skipped; not gated); in the padded-slot case, the dead key
    tiles 2-7 filled with +-3e4 leaving out, the LSE, dq and the live keys' dk
    and dv bit-equal and the dead keys' exactly 0. Per branch: CUDA-event ms
    of each kernel alone on the pre-pass's operands, device ms, the plain
    version's ms, the bound over live pairs only and torch SDPA's time given
    the same mask (`is_causal` where Sq = Skv). Returns the worst errors and
    the records by case and the launches by case."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(31)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    empty_lse = float(np.float32(-1e30 * np.log(2.0)))
    worst, records, launches_by_case, variant_records = {"k1": 0.0, "k2": 0.0, "k3": 0.0}, {}, {}, {}
    for name, provider, b, n, sq, skv, h, kind in cases:
        branch = {"segment": "segment", "causal": "causal"}.get(kind, "mask")
        q, k, v, do, (dispatch_kw, plain_kw, live) = _branch_inputs(name, b, n, sq, skv, h, kind, g)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

        def run(leaves=leaves, kw=dispatch_kw):
            out = attention_dispatch(*leaves, provider=provider, **kw)
            return (out, *torch.autograd.grad(out, leaves, do))

        torch.cuda.synchronize()
        _zero_counts()
        _zero_branch_counts()
        out, dq, dk, dv = run()
        torch.cuda.synchronize()
        counts = {k_: c for k_, c in {**_counts(), **_branch_counts()}.items() if c}
        splits = dkdv_splits(b, n, sq, skv, sms)[0]
        k1_key = "k1_mask" if branch == "mask" else "k1"
        want = {"prep": 2, k1_key: 1, "k2": 1, "k3": 1, f"k2_{branch}": 1, f"k3_{branch}": 1}
        if branch != "mask":
            want[f"k1_{branch}"] = 1
        if splits > 1:
            want["k2_reduce"] = 1
        counts_ok = counts == want
        launches_by_case[name] = counts
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA}
        library = sorted(nm for nm in names if any(t in nm.lower() for t in LIBRARY_ATTENTION))

        # The plain versions, one head at a time, on BNSH views; the backward on the kernel's out and LSE.
        qb, kb, vb, dob = (x.transpose(1, 2) for x in (q, k, v, do))
        cos, sin = plain_kw.get("rope", (None, None))
        branches = dict(causal=plain_kw.get("causal", False), q_seg=plain_kw.get("q_seg"),
                        kv_seg=plain_kw.get("kv_seg"), mask=plain_kw.get("mask"))
        k_out, k_lse = flash_forward(qb, kb, vb, None, cos, sin, None, **branches)

        (ref, ref_lse), plain_ms = timed_call(lambda: _by_head(
            lambda q_, k_, v_: flash_attention_reference(q_, k_, v_, None, cos, sin, None, **branches), n,
            (qb, kb, vb), ()))
        (ref_dq, ref_dk, ref_dv), plain_bwd_ms = timed_call(lambda: _by_head(
            lambda q_, k_, v_, o_, l_, d_: flash_backward_reference(q_, k_, v_, o_, l_, d_, None, cos, sin, None, None,
                                                                    **branches),
            n, (qb, kb, vb, k_out, k_lse, dob), ()))
        live_rows = live.expand(b, sq, skv).any(-1)[:, None, :].expand(b, n, sq)
        diff = out.transpose(1, 2).float() - ref.float()
        err = diff.abs()
        k1_err = dict(max_abs_err=err[live_rows].max().item(),
                      err_over_max1_ref=(err / ref.float().abs().clamp_min(1.0))[live_rows].max().item(),
                      rel_l2=(diff[live_rows].norm() / ref.float()[live_rows].norm()).item(),
                      lse_max_abs_err=(k_lse - ref_lse).abs()[live_rows].max().item())
        del diff, err
        empty_ok = None
        if not live_rows.all():
            empty_ok = bool(not out.transpose(1, 2)[~live_rows].any() and not dq.transpose(1, 2)[~live_rows].any()
                            and (k_lse[~live_rows] == empty_lse).all())
        bwd_err = {nm: rel_errors(got.transpose(1, 2), want_)
                   for nm, got, want_ in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
        del ref, ref_lse, ref_dq, ref_dk, ref_dv
        record = dict(k1_vs_plain=k1_err, bwd_vs_plain={nm: dict(zip(("rel_l2", "max_err_over_max_ref",
                                                                      "max_abs_err"), e))
                                                         for nm, e in bwd_err.items()})
        checks = dict(launches_exact=counts_ok, no_library_kernel=not library, empty_rows_zero=empty_ok,
                      out_equal_to_k4=bool(torch.equal(k_out, out.transpose(1, 2))))

        if kind == "segment":  # each clip alone through K1-K3 (its own tables), against the packed rows
            clip_err, lo = {}, 0
            cos_t, sin_t = dispatch_kw.get("rope_freqs", (None, None))
            for i, t in enumerate(WAN_CLIP_TOKENS if h == 128 else DUMMY_CLIP_TOKENS):
                sl = slice(lo, lo + t)
                alone = [x[:, sl].detach().clone().requires_grad_() for x in (q, k, v)]
                a_out = attention_dispatch(*alone, rope_freqs=None if cos_t is None else (cos_t[sl].contiguous(),
                                                                                          sin_t[sl].contiguous()))
                a_grads = torch.autograd.grad(a_out, alone, do[:, sl])
                e = (out[:, sl].float() - a_out.float()).abs()
                clip_err[f"clip{i}"] = dict(out_err_over_max1=(e / a_out.float().abs().clamp_min(1.0)).max().item(),
                                            out_rel_l2=rel_l2(out[:, sl].float(), a_out.float()),
                                            **{nm: rel_errors(got[:, sl], want_)[:2] for nm, got, want_ in
                                               zip(("dq", "dk", "dv"), (dq, dk, dv), a_grads)})
                lo += t
            record["clips_alone"] = clip_err
            checks["clips_equal_alone"] = all(
                c["out_err_over_max1"] <= K1_TOL and c["out_rel_l2"] <= K1_REL_L2_TOL
                and all(c[nm][0] <= BWD_REL_L2_TOL and c[nm][1] <= BWD_MAX_RATIO_TOL for nm in ("dq", "dk", "dv"))
                for c in clip_err.values())
        if kind == "causal":  # against K1's mask branch under the same causal mask
            m_out, m_lse = flash_forward(qb, kb, vb, mask=live.expand(b, sq, skv))
            e = (k_out.float() - m_out.float()).abs()
            record["vs_k1_mask_branch"] = dict(err_over_max1=(e / m_out.float().abs().clamp_min(1.0)).max().item(),
                                               rel_l2=rel_l2(k_out.float(), m_out.float()),
                                               bit_equal=bool(torch.equal(k_out, m_out)))
            checks["equals_mask_branch"] = (record["vs_k1_mask_branch"]["err_over_max1"] <= K1_TOL
                                            and record["vs_k1_mask_branch"]["rel_l2"] <= K1_REL_L2_TOL)
        if kind == "padded_slots":  # the dead key tiles 2-7 (keys 256-1023) are never read
            big = [x.detach().clone() for x in (k, v)]
            big[0][:, 256:COGVIEW4_TEXT], big[1][:, 256:COGVIEW4_TEXT] = 3e4, -3e4
            b_leaves = [leaves[0].detach().clone().requires_grad_()] + [x.requires_grad_() for x in big]
            b_out, b_dq, b_dk, b_dv = run(b_leaves)
            _, b_lse = flash_forward(qb, big[0].transpose(1, 2), big[1].transpose(1, 2), mask=plain_kw["mask"])
            dead = slice(COGVIEW4_LIVE_SLOTS, COGVIEW4_TEXT)
            live_keys = torch.ones(skv, dtype=torch.bool, device="cuda")
            live_keys[dead] = False
            checks["dead_tiles_never_read"] = bool(
                torch.equal(b_out, out) and torch.equal(b_lse, k_lse) and torch.equal(b_dq, dq)
                and torch.equal(b_dk[:, live_keys], dk[:, live_keys])
                and torch.equal(b_dv[:, live_keys], dv[:, live_keys])
                and not b_dk[:, dead].any() and not b_dv[:, dead].any())
            del b_leaves, b_out, b_dq, b_dk, b_dv, big

        # Each kernel alone on the pre-pass's operands: CUDA-event and device ms.
        scale = h**-0.5
        tables = (cos, sin)
        q_s, k_r = flash_qk_prep(qb, kb, *tables, 0, scale)
        lse_k = k_lse.contiguous()
        delta = (dob.float() * k_out.float()).sum(-1)
        mask = plain_kw.get("mask")
        if branch == "mask":
            k1_alone = lambda: flash_forward_masked_core(q_s, k_r, vb, mask)  # noqa: E731
        else:
            k1_alone = lambda: flash_forward_core(q_s, k_r, vb, None, branches["causal"], branches["q_seg"],  # noqa
                                                  branches["kv_seg"])
        bwd_ops = (q_s, k_r, vb, dob, lse_k, delta, None, *tables, 0)
        br_kw = dict(causal=branches["causal"], q_seg=branches["q_seg"], kv_seg=branches["kv_seg"], mask=mask)
        times = dict(k1_ms=cuda_ms(k1_alone), k2_ms=cuda_ms(lambda: flash_bwd_dkdv(*bwd_ops, **br_kw)),
                     k3_ms=cuda_ms(lambda: flash_bwd_dq(*bwd_ops, scale, **br_kw)),
                     k1_device_ms=device_ms(k1_alone, (BRANCH_KERNELS[branch],)),
                     k2_device_ms=device_ms(lambda: flash_bwd_dkdv(*bwd_ops, **br_kw), k2_kernels(q_s, k_r)),
                     k3_device_ms=device_ms(lambda: flash_bwd_dq(*bwd_ops, scale, **br_kw), K3_KERNELS))
        if kind == "causal":  # the unmasked kernels on the same operands, for the diagonal skip's ratio
            unmasked = dict(k1=(lambda: flash_forward_core(q_s, k_r, vb), ("flash_fwd_sm90_kernel",)),
                            k2=(lambda: flash_bwd_dkdv(*bwd_ops), k2_kernels(q_s, k_r)),
                            k3=(lambda: flash_bwd_dq(*bwd_ops, scale), K3_KERNELS))
            un = {k_: (cuda_ms(fn), device_ms(fn, names)) for k_, (fn, names) in unmasked.items()}
            record["unmasked_ms"] = {k_: v[0] for k_, v in un.items()}
            record["unmasked_device_ms"] = {k_: v[1] for k_, v in un.items()}
            record["causal_over_unmasked"] = {k_: times[f"{k_}_ms"] / un[k_][0] for k_ in un}
            record["causal_over_unmasked_device"] = {k_: times[f"{k_}_device_ms"] / un[k_][1]
                                                     if un[k_][1] and times[f"{k_}_device_ms"] else None for k_ in un}
        # torch SDPA given the same mask (is_causal where it means the same diagonal), forward and backward.
        sdpa_kw = dict(is_causal=True) if kind == "causal" and sq == skv else dict(attn_mask=live[:, None])
        s_leaves = [x.transpose(1, 2).detach().clone().requires_grad_() for x in (q, k, v)]
        s_out = F.scaled_dot_product_attention(*s_leaves, **sdpa_kw)
        times["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, **sdpa_kw))
        times["sdpa_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(s_out, s_leaves, dob, retain_graph=True))
        del s_out, s_leaves
        live_pairs = int(live.expand(b, sq, skv).sum())
        bounds = branch_bounds(b, n, sq, skv, h, live_pairs)
        record.update(times, shape=[b, n, sq, skv, h], plain_ms=plain_ms, plain_backward_ms=plain_bwd_ms,
                      live_pairs=live_pairs, k1_bound=bounds[0], k2_bound=bounds[1],
                      k3_bound=bounds[2], k2_splits=splits)
        phase("attention_branches", case=name, provider=provider, branch=branch, launches=counts,
              library_kernels=library, checks=checks, **record, card=card)
        ok = (k1_err["err_over_max1_ref"] <= K1_TOL and k1_err["rel_l2"] <= K1_REL_L2_TOL
              and k1_err["lse_max_abs_err"] <= LSE_TOL
              and all(e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL for e in bwd_err.values())
              and all(v_ is not False for v_ in checks.values()))
        if not ok:
            raise AssertionError(f"attention branch case {name} failed: {checks}, {k1_err}, {bwd_err}")
        worst["k1"] = max(worst["k1"], k1_err["max_abs_err"])
        worst["k2"] = max(worst["k2"], bwd_err["dk"][2], bwd_err["dv"][2])
        worst["k3"] = max(worst["k3"], bwd_err["dq"][2])
        records[name] = dict(branch=branch, **record)
        variant_records[name] = check_variant_branches(
            card, dict(name=name, kind=kind, branch=branch, shape=(b, n, sq, skv, h), run=run, leaves=leaves, do=do,
                       dispatch_kw=dispatch_kw, branches=branches, tables=tables, live=live, k_out=k_out, k_lse=k_lse,
                       grads=(dq, dk, dv), q_s=q_s, k_r=k_r, delta=delta, times=times, record=record))
        del q, k, v, do, leaves, out, dq, dk, dv, q_s, k_r, k_out, k_lse, live
        torch.cuda.empty_cache()
    check_branch_switches(card)
    check_branch_pairs(card)
    return worst, records, launches_by_case, variant_records


# The switches, and the forward kernels they pick for a branch call (JAX's gates, `forward_variant`): the skewed and
# two-pass kernels take segment ids only (JAX gates causal and masked calls off both); a causal or masked call
# under them runs K1's branch.
SWITCH_FORWARD = {"FINETRAINERS_FLASH_SKEW": "k7b", "FINETRAINERS_FLASH_TWOPASS": "k7a",
                  "FINETRAINERS_FLASH_TWOLEVEL": "k7c", "FINETRAINERS_FLASH_FUSED_BWD": None}


def switch_launches(sw, branch, splits):
    """The launches of one forward and backward of a `branch` call under the switch `sw`, by `_counts()` and
    `_branch_counts()` key: the pre-pass before each (but K7b's forward), the forward kernel's branch (K1's
    where the switch's kernel has none), and K2's and K3's (K2 with its reduce pass where `splits`, as
    `dkdv_splits` cuts its q loop, exceeds 1), or K5's and its dq emit."""
    fwd = SWITCH_FORWARD[sw]
    if fwd in ("k7a", "k7b") and branch != "segment":
        fwd = None
    want = {"prep": 1 if fwd == "k7b" else 2}
    if fwd is None:
        want.update({"k1_mask": 1} if branch == "mask" else {"k1": 1, f"k1_{branch}": 1})
    else:
        want.update({fwd: 1, f"{fwd}_{branch}": 1})
    if sw == "FINETRAINERS_FLASH_FUSED_BWD":
        want.update({"k5": 1, f"k5_{branch}": 1, "k5_emit": 1})
    else:
        want.update({"k2": 1, "k3": 1, f"k2_{branch}": 1, f"k3_{branch}": 1, **({"k2_reduce": 1} if splits > 1 else {})})
    return want


def check_branch_switches(card):
    """Every (switch, branch) pair on the card, as JAX's gates send it
    (`_flash_forward` :724-733, `_flash_backward` :1432; `switch_launches`):
    each pair's forward and backward once with the counts zeroed just before,
    which must launch exactly the picked kernels' branches; out and the LSE
    against the picked forward's plain version within K1's tolerances on rows
    with a live key (rows without one exactly 0), dq, dk and dv against the
    plain backward (K5's under the fused switch) within K2/K3's. Small bf16
    shapes (2, 2, 300, 300, H) at head dims 128 and 32 with kv_lens; no RoPE
    tables (JAX gates the skewed kernel off them)."""
    results, ok = {}, True
    for h in (128, 32):
        h_results, h_ok = _branch_switches_at(h)
        results.update({f"h{h}:{key}": r for key, r in h_results.items()})
        ok = ok and h_ok
    phase("attention_branches_switches", results=results, routing_as_jax=ok, card=card)
    if not ok:
        raise AssertionError(f"a branch under a kernel switch failed its checks: {results}")


def _branch_switches_at(h):
    """`check_branch_switches` at head dim `h` -> (results by "switch:branch", all ok)."""
    g = torch.Generator(device="cuda").manual_seed(33)
    q, k, v, do = (torch.randn(2, 2, 300, h, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor([280, 300], dtype=torch.int32, device="cuda")
    ids = (torch.arange(300, device="cuda") // 100).to(torch.int32)[None].repeat(2, 1)
    mask = torch.rand(2, 300, 300, generator=g, device="cuda") > 0.5
    mask[1, 7] = False  # a row with no live key
    inputs = {"causal": dict(causal=True), "segment": dict(q_seg=ids, kv_seg=ids), "mask": dict(mask=mask)}
    plain_fwd = {None: flash_attention_reference, **{key: ref for key, (_, ref) in K7_KERNELS.items()}}
    results, ok = {}, True
    for sw, fwd in SWITCH_FORWARD.items():
        for branch, kw in inputs.items():
            torch.cuda.synchronize()
            _zero_counts()
            _zero_branch_counts()
            with switch(sw):
                out, lse = flash_forward(q, k, v, lens, **kw)
                grads = flash_backward(q, k, v, out, lse, do, lens, **kw)
            torch.cuda.synchronize()
            counts = {k_: c for k_, c in {**_counts(), **_branch_counts()}.items() if c}
            want = switch_launches(sw, branch, dkdv_splits(2, 2, 300, 300, torch.cuda.get_device_properties(0)
                                                            .multi_processor_count)[0])
            picked = fwd if fwd in want else None
            ref, ref_lse = plain_fwd[picked](q, k, v, lens, **kw)
            plain_bwd = flash_backward_fused_reference if sw == "FINETRAINERS_FLASH_FUSED_BWD" else \
                flash_backward_reference
            refs = plain_bwd(q, k, v, out, lse, do, lens, **kw)
            live = live_pairs(2, 300, 300, "cuda", lens, **kw)[:, 0].any(-1)[:, None].expand(2, 2, 300)
            err = (out.float() - ref.float()).abs()
            fwd_err = dict(err_over_max1_ref=(err / ref.float().abs().clamp_min(1.0))[live].max().item(),
                           lse_max_abs_err=(lse - ref_lse).abs()[live].max().item())
            bwd_err = {nm: rel_errors(got, want_)[:2] for nm, got, want_ in zip(("dq", "dk", "dv"), grads, refs)}
            empty_zero = bool(not out[~live].any() and not grads[0][~live].any())
            pair_ok = (counts == want and fwd_err["err_over_max1_ref"] <= K1_TOL and fwd_err["lse_max_abs_err"]
                       <= LSE_TOL and empty_zero and all(e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL
                                                         for e in bwd_err.values()))
            results[f"{sw}:{branch}"] = dict(launches=counts, launches_exact=counts == want, vs_plain=fwd_err,
                                             bwd_vs_plain=bwd_err, empty_rows_zero=empty_zero, ok=pair_ok)
            ok = ok and pair_ok
    return results, ok


# K2's and K3's branches pair by pair: (name, B, N, Sq, Skv, branch, kv_lens). Lengths off the tiles, Sq < Skv and
# Sq > Skv for the causal offset (rows with no key), the q loop split (few CTAs) and whole (N = 72), kv_lens,
# packed ids with -1 padding, and a block-sparse mask with an empty tile and an empty row. Sq <= 256, so that a count
# of live q rows per key is exact in bf16.
PAIR_CASES = (
    ("causal_self", 1, 2, 256, 256, "causal", None),
    ("causal_self_whole_q_loop", 1, 72, 256, 256, "causal", None),
    ("causal_q_short", 1, 2, 200, 330, "causal", [300]),
    ("causal_q_long", 1, 2, 256, 100, "causal", None),
    ("segment_packed", 2, 2, 256, 256, "segment", [250, 256]),
    ("segment_cross_whole_q_loop", 1, 72, 240, 330, "segment", None),
    ("mask_sparse", 2, 2, 250, 330, "mask", [300, 330]),
    ("mask_whole_q_loop", 1, 72, 256, 256, "mask", None),
)


def pair_probe_inputs(b, sq, skv, branch):
    """PAIR_CASES' branch inputs (causal, q_seg, kv_seg, mask): packed ids in
    runs of 37 rows, the last 9 rows -1 (the keys' runs 61 where Sq != Skv),
    or `block_sparse_mask`."""
    g = torch.Generator(device="cuda").manual_seed(sq + skv)
    if branch == "causal":
        return True, None, None, None
    if branch == "segment":
        def ids(s, run):
            x = (torch.arange(s, device="cuda") // run).to(torch.int32)[None].repeat(b, 1)
            x[:, s - 9:] = -1
            return x
        return False, ids(sq, 37), ids(skv, 37 if sq == skv else 61), None
    return False, None, None, block_sparse_mask(b, sq, skv, g)


def branch_pair_errors(b, n, sq, skv, h, branch, lens=None, fused=False):
    """The pairs K2's and K3's `branch` (with `fused`, K5's) gets wrong, counted
    exactly through `flash_backward` on operands whose scores are all 0 (p = 1
    where live, with lse = 0, and dp = 1, delta = 0, so ds = 1 where live): for
    each block of H q rows, q one-hot over the block and k = 0, so that column
    j of dk is ds at q row q0 + j (K2's or K5's selects pair by pair) and
    column 0 of dv counts each key's live q rows (their p); for each block of
    H keys, k one-hot over the block and q = 0, so that column j of dq is ds
    at key k0 + j (K3's, or the ds^T tile K5's dq product reads). Returns
    {"k2_ds", "k2_p", "k3_ds"}: the pairs (or keys, for "k2_p") that differ
    from `live_pairs`, 0 where the branch is exact."""
    causal, q_seg, kv_seg, mask = pair_probe_inputs(b, sq, skv, branch)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = live_pairs(b, sq, skv, "cuda", kv_lens, causal, q_seg, kv_seg, mask)[:, 0]
    counts = live.sum(1).float()[:, None]  # (B, 1, Skv): each key's live q rows
    zeros = lambda s: torch.zeros(b, s, n, h, dtype=torch.bfloat16, device="cuda")  # noqa: E731
    e0 = zeros(max(sq, skv))
    e0[..., 0] = 1
    stats = torch.zeros(b, n, sq, device="cuda")

    def grads(q, k):
        with switch("FINETRAINERS_FLASH_FUSED_BWD" if fused else None):
            return flash_backward(q.transpose(1, 2), k.transpose(1, 2), e0[:, :skv].transpose(1, 2),
                                  zeros(sq).transpose(1, 2), stats, e0[:, :sq].transpose(1, 2), kv_lens, delta=stats,
                                  causal=causal, q_seg=q_seg, kv_seg=kv_seg, mask=mask)

    wrong = dict(k2_ds=0, k2_p=0, k3_ds=0)
    for q0 in range(0, sq, h):
        r = min(h, sq - q0)
        q = zeros(sq)
        q[:, q0:q0 + r, :, :r] = torch.eye(r, dtype=torch.bfloat16, device="cuda")[None, :, None]
        _, dk, dv = grads(q, zeros(skv))
        wrong["k2_ds"] += int(((dk[..., :r] != 0) != live[:, None, q0:q0 + r].transpose(2, 3)).sum()
                              + (dk[..., r:] != 0).sum())
        wrong["k2_p"] += int(((dv[..., 0].float() - counts).abs() > 0.5).sum() + (dv[..., 1:] != 0).sum())
    for k0 in range(0, skv, h):
        r = min(h, skv - k0)
        k = zeros(skv)
        k[:, k0:k0 + r, :, :r] = torch.eye(r, dtype=torch.bfloat16, device="cuda")[None, :, None]
        dq, _, _ = grads(zeros(sq), k)
        wrong["k3_ds"] += int(((dq[..., :r] != 0) != live[:, None, :, k0:k0 + r]).sum() + (dq[..., r:] != 0).sum())
    return wrong


def check_branch_pairs(card):
    """K2's and K3's causal, segment and mask branches, and K5's, at H 32, 64
    and 128 select exactly the live pairs (`branch_pair_errors` over PAIR_CASES; K5's
    under the fused switch, its cases suffixed `_k5`): a fault that drops or adds
    a few pairs stays under the relative-L2 bounds at the models' widths, and
    shows here."""
    results = {f"{name}_h{h}{'_k5' if fused else ''}": branch_pair_errors(b, n, sq, skv, h, branch, lens, fused)
               for name, b, n, sq, skv, branch, lens in PAIR_CASES for h in (32, 64, 128)
               for fused in (False, True)}
    ok = all(not any(w.values()) for w in results.values())
    phase("attention_branch_pairs", wrong_pairs=results, exact=ok, card=card)
    if not ok:
        raise AssertionError(f"K2's, K3's or K5's branch selects pairs that are not the live ones: {results}")


# The text towers at their published widths and depths (ROADMAP.md queue 1 item 7), random weights from a seeded
# generator on the card, bf16, each encode held against the same tower under plain fp32 attention.
TOWER_REL_L2_TOL = 5e-2
# CogView4 from a local diffusers directory written here: the transformer at full width cut to 2 of 28 blocks,
# the 2D AutoencoderKL at its default widths with 16 latent channels, GLM-4 at full width cut to 2 of 40 layers.
CKPT_BLOCKS, CKPT_GLM_LAYERS, CKPT_SERVE_STEPS, CKPT_RANK = 2, 2, 2, 32


class StubTokenizer:
    """A tokenizer stand-in (neither machine has the towers' tokenizer files):
    caption i of `lengths` tokens gets ids drawn from a seeded generator below
    `vocab`, then `eos_id` where given, padded with `pad_id` as the call asks."""

    def __init__(self, lengths, vocab, pad_id=0, eos_id=None):
        self.lengths, self.vocab, self.pad_token_id, self.eos_id = list(lengths), vocab, pad_id, eos_id

    def __call__(self, texts, padding=None, max_length=None, truncation=None, return_tensors=None, **kwargs):
        lengths = [self.lengths[i % len(self.lengths)] for i in range(len(texts))]
        width = max_length if padding == "max_length" else max(lengths)
        rng = np.random.RandomState(len(texts))
        ids = np.full((len(texts), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(texts), width), np.int64)
        for i, n in enumerate(lengths):
            n = min(n, width)
            ids[i, :n] = rng.randint(3, self.vocab - 1, n)
            if self.eos_id is not None:
                ids[i, n - 1] = self.eos_id
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _tower_handle(kind, layers=None, seed=0):
    """(handle, layers, what the spec consumes) for a published tower, random on the card."""
    from finetrainers_tpu_torch.models.text_encoders import (CLIP_L_TEXT_CONFIG, GLM4_9B_CONFIG, LLAMA3_8B_CONFIG,
                                                             CLIPTextConfig, CLIPTextHandle, CLIPTextTower,
                                                             DecoderConfig, DecoderTextModel, GlmHandle, LlamaHandle)

    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "clip_l_text":
        cfg = CLIPTextConfig.from_hf(CLIP_L_TEXT_CONFIG)
        with torch.device("cuda"):
            module = CLIPTextTower(cfg, torch.bfloat16)
        tokenizer = StubTokenizer([40, 77], cfg.vocab_size, pad_id=cfg.eos_token_id, eos_id=cfg.eos_token_id)
        return CLIPTextHandle.from_tower(cfg, init_parameters_(module, g), tokenizer), cfg.num_hidden_layers
    published = GLM4_9B_CONFIG if kind == "glm4_9b" else LLAMA3_8B_CONFIG
    cfg = (DecoderConfig.glm if kind == "glm4_9b" else DecoderConfig.llama)(
        dict(published, num_hidden_layers=layers or published["num_hidden_layers"]))
    with torch.device("cuda"):
        module = DecoderTextModel(cfg, torch.bfloat16)
    if kind == "glm4_9b":  # 1008 ids, left-padded by 16 to 1024: K1's GLM shape
        tokenizer = StubTokenizer([1008], cfg.vocab_size, pad_id=published["pad_token_id"])
        return GlmHandle.from_tower(cfg, init_parameters_(module, g), tokenizer), cfg.num_hidden_layers
    # 120 and 351 ids of the 256 + 95 template slots HunyuanVideo's processor encodes: a padding mask
    tokenizer = StubTokenizer([120, 351], cfg.vocab_size)
    return LlamaHandle.from_tower(cfg, init_parameters_(module, g), tokenizer), cfg.num_hidden_layers


def _encode(kind, handle):
    """The states the spec consumes: GLM `hidden_states[-2]`, Llama `hidden_states[-3]` at 351 slots, CLIP's
    pooled output (and its last state)."""
    if kind == "glm4_9b":
        return (handle.encode(["a caption"])[0],)
    if kind == "llama3_8b":
        return (handle.encode(["a caption", "another caption"], max_sequence_length=351)[0],)
    return handle.encode_pooled(["a caption", "another caption"]), handle.encode(["a", "b"])[0]


def text_towers(card):
    """GLM-4-9B (40 layers, 32 heads over 2 kv heads x 128, partial rotary 0.5,
    QKV bias), HunyuanVideo's Llama-3-8B (32 layers, 32 over 8 heads) and
    CLIP-L's text tower (12 layers, 77 positions, quick_gelu) at their published
    configs (`models/text_encoders/towers.py`), random weights drawn on the card
    from a seeded generator, bf16: `encode` through each handle with a stub
    tokenizer, exactly one launch of K1's mask branch (and its pre-pass) per
    layer and no other attention kernel, the consumed states held against the
    same tower under `_native_math` (plain fp32 attention), seconds and peak
    memory; each tower freed before the next. Returns the launches by tower."""
    launches = {}
    for kind in ("glm4_9b", "llama3_8b", "clip_l_text"):
        t0 = time.perf_counter()
        handle, layers = _tower_handle(kind)
        params = sum(p.numel() for p in handle.module.parameters())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _encode(kind, handle)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        got = _encode(kind, handle)
        torch.cuda.synchronize()
        encode_s, counts = time.perf_counter() - t0, _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with attention_provider("_native_math"):
            want = _encode(kind, handle)
        errs = [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got, want)]
        calls = 2 if kind == "clip_l_text" else 1  # CLIP: the pooled and the last-state encodes
        want_counts = {k_: (layers * calls if k_ in ("k1_mask", "prep") else 0) for k_ in counts}
        finite = all(np.isfinite(x).all() for x in got)
        phase("text_towers", tower=kind, layers=layers, params=params, shapes=[list(x.shape) for x in got],
              build_s=build_s, encode_s=encode_s, peak_gb=peak_gb, launches=counts, launches_exact=counts == want_counts,
              rel_l2_vs_plain_attention=errs, bound=TOWER_REL_L2_TOL, finite=finite, card=card)
        if not (finite and counts == want_counts and max(errs) <= TOWER_REL_L2_TOL):
            raise AssertionError(f"the {kind} tower failed its checks: launches {counts}, errors {errs}")
        launches[kind] = counts["k1_mask"]
        del handle
        _free_cuda()
    return launches


def cogview4_checkpoint_serve(card):
    """CogView4 from a local diffusers directory: `transformer/` at full width
    cut to 2 of 28 blocks with its config.json, `vae/` the 2D AutoencoderKL at
    its default widths with 16 latent channels, `text_encoder/` GLM-4 at full
    width cut to 2 of 40 layers, all bf16 and random from a seeded generator,
    written here, then loaded through the spec (rank-32 LoRA): base weights
    bit-equal to the files, the LoRA factors a fresh model's, each handle the
    tower's; one 1024x1024 CFG request of 2 steps through `CogView4Pipeline`
    whose prompt the loaded GLM encodes (stub tokenizer) and whose latents the
    loaded VAE decodes: K1's mask branch 2 launches per GLM encode (prompt and
    negative), K1 2 per denoise step. The runner's tokenizer waits for
    `transformers` and tokenizer files on the card (`env` says whether it
    imports); its request runs again under `--attn_provider flex` (the GLM's
    causal mask to the same mask branch, the transformer to the same K1),
    whose image must be bit-equal. Returns the launches."""
    from finetrainers_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from finetrainers_tpu_torch.models.cogview4 import COGVIEW4_TRANSFORMER_CONFIG, CogView4ModelSpecification
    from finetrainers_tpu_torch.models.cogview4.transformer import CogView4Transformer2DModel
    from finetrainers_tpu_torch.models.text_encoders import GLM4_9B_CONFIG, DecoderConfig, DecoderTextModel, GlmHandle
    from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict

    root = SMOKE_DIR / "cogview4_local_checkpoint"
    config = dict(COGVIEW4_TRANSFORMER_CONFIG, num_layers=CKPT_BLOCKS)
    vae_config = dict(latent_channels=16, scaling_factor=1.0, shift_factor=0.0)
    glm_config = dict(GLM4_9B_CONFIG, num_hidden_layers=CKPT_GLM_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    written = {}
    for sub, cfg, build, file in (
            ("transformer", dict(config, _class_name="CogView4Transformer2DModel"),
             lambda: CogView4Transformer2DModel(**config, dtype=torch.bfloat16), "diffusion_pytorch_model"),
            ("vae", dict(vae_config, _class_name="AutoencoderKL"),
             lambda: AutoencoderKL(AutoencoderKLConfig.from_hf(vae_config), torch.bfloat16), "diffusion_pytorch_model"),
            ("text_encoder", glm_config, lambda: DecoderTextModel(DecoderConfig.glm(glm_config), torch.bfloat16),
             "model")):
        with torch.device("cuda"):
            module = init_parameters_(build(), g)
        written[sub] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        del module
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(cfg))
        prefix = "model." if sub == "text_encoder" else ""
        safetensors_save_dict({prefix + k: v for k, v in written[sub].items()}, str(root / sub / f"{file}.safetensors"))
    write_s = time.perf_counter() - t0

    def spec_at(path):
        return CogView4ModelSpecification(pretrained_model_name_or_path=str(path), transformer_config=config,
                                          device="cuda", lora_rank=CKPT_RANK, lora_alpha=CKPT_RANK)

    spec, load_s = spec_at(root), {}
    for name, load in (("transformer", lambda: spec.load_diffusion_models()["transformer"]),
                       ("vae", lambda: spec.load_latent_models()["vae"]),
                       ("text_encoder", lambda: spec.load_condition_models()["text_encoder"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_s[name] = load()
        torch.cuda.synchronize()
        load_s[name] = (load_s[name], time.perf_counter() - t0)
    (transformer, _), (vae, _), (text_encoder, _) = load_s.values()
    load_s = {name: seconds for name, (_, seconds) in load_s.items()}
    state = transformer.module.state_dict()
    base_equal = {"transformer": all(torch.equal(state[k], v) for k, v in written["transformer"].items()),
                  "vae": all(torch.equal(v, written["vae"][k]) for k, v in vae.module.state_dict().items())
                  and vae.module.state_dict().keys() == written["vae"].keys(),
                  "text_encoder": isinstance(text_encoder, GlmHandle) and all(
                      torch.equal(v, written["text_encoder"][k]) for k, v in text_encoder.module.state_dict().items())}
    fresh = spec_at(root / "absent").load_diffusion_models()["transformer"].module.state_dict()
    lora = [k for k in state if ".lora_" in k]
    lora_fresh = bool(lora) and all(torch.equal(state[k], fresh[k]) for k in lora)
    del fresh, written
    torch.cuda.empty_cache()
    handles_ok = isinstance(vae.module, AutoencoderKL) and isinstance(text_encoder, GlmHandle)
    text_encoder.tokenizer = StubTokenizer([120], glm_config["vocab_size"], pad_id=glm_config["pad_token_id"])
    pipe = spec.load_pipeline(transformer=transformer, vae=vae, text_encoder=text_encoder)
    request = dict(prompt=PROMPTS[0], height=1024, width=1024, num_inference_steps=CKPT_SERVE_STEPS,
                   guidance_scale=3.5, seed=0)
    pipe(**dict(request, num_inference_steps=1))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    image = pipe(**request)
    torch.cuda.synchronize()
    request_s, counts = time.perf_counter() - t0, _counts()
    want = {k_: 0 for k_ in counts}
    want.update(k1_mask=2 * CKPT_GLM_LAYERS, k1=CKPT_BLOCKS * CKPT_SERVE_STEPS,
                prep=2 * CKPT_GLM_LAYERS + CKPT_BLOCKS * CKPT_SERVE_STEPS)
    image_ok = image.shape == (1024, 1024, 3) and image.dtype == np.uint8 and image.std() > 0
    request_peak_gb, handles, vae_cfg = (torch.cuda.max_memory_allocated() / 1e9,
                                         [type(text_encoder).__name__, type(vae.module).__name__], vae.config)
    del pipe, transformer, vae, text_encoder, spec
    _free_cuda()
    runner = _checkpoint_runner(root, config, want)
    phase("cogview4_checkpoint_serve", blocks=CKPT_BLOCKS, glm_layers=CKPT_GLM_LAYERS,
          files_gb=sum(f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9, write_s=write_s, load_s=load_s,
          base_weights_bit_equal=base_equal, lora_factors_fresh=lora_fresh, lora_tensors=len(lora),
          handles=handles, vae_config=vae_cfg,
          request=dict(request, steps_note="cut from the request's 50"), request_s=request_s,
          peak_gb=request_peak_gb, launches=counts, launches_exact=counts == want,
          image_shape=list(image.shape), image_std=float(image.std()), runner=runner,
          jax_imported="jax" in sys.modules, card=card)
    if not (all(base_equal.values()) and lora_fresh and handles_ok and image_ok and counts == want
            and runner.get("ok", True) and "jax" not in sys.modules):
        raise AssertionError(f"the CogView4 checkpoint path failed its checks: {base_equal}, LoRA fresh {lora_fresh}, "
                             f"launches {counts}, runner {runner}")
    _free_cuda()
    shutil.rmtree(root)
    return counts, runner


# The `flex` request under FINETRAINERS_FLASH_TWOLEVEL=1 against the default one: K7c reorders K1's fp32 softmax
# arithmetic (the tile's own max, then alpha and beta), which moves a bf16 output by an ulp now and then (K7c's mask
# branch at the models' widths is within one bf16 ulp of K1's, `variant_branches`); the GLM's 2 layers, the
# transformer's 2 blocks and 2 CFG steps at random weights carry that to the latents as they carry any bf16
# attention's rounding: the bound of a step against plain attention (LTX's step, SDPA's own deviation 0.034).
TWOLEVEL_LATENT_REL_L2_TOL = STEP_REL_L2_TOL


def _checkpoint_runner(root, config, want):
    """Where `transformers` and `tokenizers` import: the same request through the
    runner (`inference.main --model_name cogview4` on the directory, its
    guidance 5.0 as a CFG batch of 2) with `--tokenizer_id` a word-level
    tokenizer written here (the GLM tokenizer's files are on neither machine),
    so the runner's own `AutoTokenizer` load feeds the loaded GLM; then under
    `--attn_provider flex` (bit-equal, K1's mask branch and K1 as by default),
    and under `flex` with FINETRAINERS_FLASH_TWOLEVEL=1, where the GLM's mask
    takes K7c's mask branch (2 launches per layer) and the transformer K7c
    (one a block and step), with the latents the VAE decodes within
    TWOLEVEL_LATENT_REL_L2_TOL of the default request's. Returns its record;
    without those packages, why it did not run."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.models.cogview4 import pipeline as cogview4_pipeline

    import cv2

    try:
        from tokenizers import Tokenizer, models, pre_tokenizers
        import transformers  # noqa: F401
    except ImportError as e:
        return {"skipped": f"the runner's tokenizer waits for transformers and tokenizers ({e})"}
    words = sorted(set(PROMPTS[0].split()))
    tokenizer = Tokenizer(models.WordLevel({"<pad>": 0, "<unk>": 1, **{w: 2 + i for i, w in enumerate(words)}},
                                           unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    (root / "tokenizer").mkdir()
    tokenizer.save(str(root / "tokenizer" / "tokenizer.json"))
    (root / "tokenizer" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "unk_token": "<unk>",
         "model_max_length": 1024}))
    argv = ["--model_name", "cogview4", "--pretrained_model_name_or_path", str(root), "--tokenizer_id",
            str(root / "tokenizer"), "--inference_type", "text_to_image", "--prompt", PROMPTS[0], "--height", "1024",
            "--width", "1024", "--num_inference_steps", str(CKPT_SERVE_STEPS)]
    runs, decode = {}, cogview4_pipeline.decode_image_vae
    for provider, sw in ((None, None), ("flex", None), ("flex", "FINETRAINERS_FLASH_TWOLEVEL")):
        flags = [] if provider is None else ["--attn_provider", provider]
        latents = []
        cogview4_pipeline.decode_image_vae = lambda vae, x, *a, **kw: latents.append(x.float()) or decode(vae, x, *a,
                                                                                                          **kw)
        torch.cuda.synchronize()
        _zero_counts()
        _zero_branch_counts()
        t0 = time.perf_counter()
        try:
            with switch(sw):
                paths = inference.main([*argv, *flags, "--output_dir", str(root / f"served_{provider}_{sw}")],
                                       transformer_config=config)
        finally:
            cogview4_pipeline.decode_image_vae = decode
        torch.cuda.synchronize()
        seconds, counts = time.perf_counter() - t0, _counts()
        runs[provider, sw] = dict(seconds=seconds, launches=counts,
                                  branch_launches={k_: n_ for k_, n_ in _branch_counts().items() if n_},
                                  image=cv2.imread(paths[0]), latents=latents[0])
        _free_cuda()
    default, flex, two_level = runs[None, None], runs["flex", None], runs["flex", "FINETRAINERS_FLASH_TWOLEVEL"]
    written = default["image"]
    shape = None if written is None else list(written.shape)
    flex_equal = written is not None and np.array_equal(written, flex["image"])
    flex_counts_ok = flex["launches"] == want and not flex["branch_launches"]
    want_two_level = {k_: 0 for k_ in want}
    want_two_level.update(k7c=want["k1_mask"] + want["k1"], prep=want["prep"])
    two_level_counts_ok = (two_level["launches"] == want_two_level
                           and two_level["branch_launches"] == {"k7c_mask": want["k1_mask"]})
    two_level_rel_l2 = rel_l2(two_level["latents"], default["latents"])
    return dict(entry="python -m finetrainers_tpu_torch.inference", argv=argv, seconds=default["seconds"],
                launches=default["launches"], written_shape=shape, flex_seconds=flex["seconds"],
                flex_launches=flex["launches"], flex_image_bit_equal=flex_equal,
                flex_two_level_seconds=two_level["seconds"], flex_two_level_launches=two_level["launches"],
                flex_two_level_branch_launches=two_level["branch_launches"],
                flex_two_level_launches_exact=two_level_counts_ok, flex_two_level_latent_rel_l2=two_level_rel_l2,
                flex_two_level_latent_bound=TWOLEVEL_LATENT_REL_L2_TOL,
                ok=default["launches"] == want and shape == [1024, 1024, 3] and flex_equal and flex_counts_ok
                and two_level_counts_ok and two_level_rel_l2 <= TWOLEVEL_LATENT_REL_L2_TOL)


# Wan 2.1 and LTX-Video from local diffusers directories written here: the faithful VAEs whole at
# their published configs, the T5 towers at full width cut to 2 of 24 layers, Wan's transformer whole, LTX's at full
# width cut to 2 of 28 blocks (the whole depth serves in `serve`). The published latent statistics are not in the
# repository: Wan's VAE config takes a seeded pair of 16-vectors instead.
VIDEO_T5_LAYERS, LTX_CKPT_BLOCKS, VIDEO_CKPT_STEPS = 2, 2, 2
LTX_CKPT_REQUEST = dict(height=512, width=768, num_frames=49, num_inference_steps=VIDEO_CKPT_STEPS, guidance_scale=3.0)
VAE_REL_L2_TOL = 5e-2  # a bf16 encode against fp32's, relative L2 of the moments' mean half


def _word_tokenizer(directory, texts, max_length):
    """A word-level tokenizer of `texts`' words written to `directory` (neither machine has T5's files): ids
    <pad> 0, </s> 1, <unk> 2, EOS appended as T5's tokenizer appends it; transformers' `AutoTokenizer` loads it."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    words = sorted({w for t in texts for w in re.findall(r"\w+|[^\w\s]+", t)})
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: 3 + i for i, w in enumerate(words)}}
    tokenizer = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    tokenizer.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    directory.mkdir(parents=True)
    tokenizer.save(str(directory / "tokenizer.json"))
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "unk_token": "<unk>", "eos_token": "</s>",
         "model_max_length": max_length}))
    return directory


def _write_component(path, config, module, file, extra=None):
    """`module`'s state (and `extra` tensors) as `file` beside `config` as config.json; returns the seconds."""
    from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(config))
    safetensors_save_dict({**module.state_dict(), **(extra or {})}, str(path / file))
    return time.perf_counter() - t0


def _t5_tower(config, layers, dtype, seed):
    from finetrainers_tpu_torch.models.text_encoders import T5Config, T5EncoderTower

    cfg = T5Config.from_hf(dict(config, num_layers=layers))
    with torch.device("cuda"):
        return init_parameters_(T5EncoderTower(cfg, dtype), torch.Generator("cuda").manual_seed(seed)).eval()


def _equal_to_files(module, path, skip=(".lora_",)):
    """Whether every tensor of the safetensors files under `path` equals `module`'s of that name, and every
    parameter of `module` (but `skip`'s) is in them."""
    from finetrainers_tpu_torch.utils.serialization import safetensors_load_dict

    files = {}
    for f in sorted(path.glob("*.safetensors")):
        files.update(safetensors_load_dict(str(f)))
    state = {n: v for n, v in module.state_dict().items() if not any(s in n for s in skip)}
    return state.keys() <= files.keys() and all(torch.equal(v.cpu(), files[n]) for n, v in state.items())


def write_wan_checkpoint(root):
    """Wan 2.1 T2V-1.3B as a diffusers directory: `transformer/` whole, `vae/` AutoencoderKLWan at its published
    config with a seeded latent-statistics pair, `text_encoder/` UMT5-XXL at full width cut to VIDEO_T5_LAYERS (with
    layer 1's own relative-attention table, as a UMT5 checkpoint holds one a layer), `tokenizer/` a word-level
    tokenizer; bf16, random from seeded generators on the card. Returns the write seconds by component."""
    from finetrainers_tpu_torch.models.text_encoders import UMT5_XXL_CONFIG
    from finetrainers_tpu_torch.models.wan import WAN_T2V_1_3B_CONFIG
    from finetrainers_tpu_torch.models.wan.transformer import WanTransformer3DModel
    from finetrainers_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig

    g = torch.Generator("cuda").manual_seed(11)
    seconds = {}
    with torch.device("cuda"):
        module = init_parameters_(WanTransformer3DModel(**WAN_T2V_1_3B_CONFIG, dtype=torch.bfloat16), g)
    seconds["transformer"] = _write_component(root / "transformer", dict(
        WAN_T2V_1_3B_CONFIG, _class_name="WanTransformer3DModel"), module, "diffusion_pytorch_model.safetensors")
    del module
    rng = np.random.RandomState(12)
    vae_config = dict(base_dim=96, z_dim=16, dim_mult=[1, 2, 4, 4], num_res_blocks=2, attn_scales=[],
                      temperal_downsample=[False, True, True], latents_mean=(rng.randn(16) * 0.5).tolist(),
                      latents_std=rng.uniform(0.5, 2.5, 16).tolist(), _class_name="AutoencoderKLWan")
    with torch.device("cuda"):
        module = init_parameters_(AutoencoderKLWan(WanVAEConfig.from_hf(vae_config), torch.bfloat16), g)
    seconds["vae"] = _write_component(root / "vae", vae_config, module, "diffusion_pytorch_model.safetensors")
    del module
    module = _t5_tower(UMT5_XXL_CONFIG, VIDEO_T5_LAYERS, torch.bfloat16, 13)
    extra = {f"encoder.block.{i}.layer.0.SelfAttention.relative_attention_bias.weight":
             torch.randn(32, 64, generator=g, device="cuda").bfloat16() for i in range(1, VIDEO_T5_LAYERS)}
    seconds["text_encoder"] = _write_component(
        root / "text_encoder", dict(UMT5_XXL_CONFIG, num_layers=VIDEO_T5_LAYERS), module, "model.safetensors", extra)
    del module
    (root / "model_index.json").write_text(json.dumps({"_class_name": "WanPipeline"}))
    (root / "scheduler").mkdir()  # UniPC bh2 with shift 3, as the published T2V-1.3B scheduler config names it
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(I2V_SCHEDULER_CONFIG))
    return seconds


def _timed_vae(cls):
    """Wrap `cls.encode` and `cls.decode` to record (method, seconds, input shape) of each call, synchronised."""
    record, originals = [], (cls.encode, cls.decode)

    def timed(name, fn):
        def wrapper(self, x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, x)
            torch.cuda.synchronize()
            record.append((name, time.perf_counter() - t0, list(x.shape)))
            return out
        return wrapper

    cls.encode, cls.decode = timed("encode", originals[0]), timed("decode", originals[1])
    return record, lambda: setattr(cls, "encode", originals[0]) or setattr(cls, "decode", originals[1])


def wan_checkpoint_run(card):
    """Wan 2.1 T2V-1.3B from a local diffusers directory written here
    (`write_wan_checkpoint`): the crush_smol_lora train.sh's flags through
    `python -m finetrainers_tpu_torch.train --pretrained_model_name_or_path
    <dir> --tokenizer_id <dir>/tokenizer` on `wan_run`'s two videos at
    49x480x832, precomputed through the faithful VAE (tiled as the example
    asks) and UMT5 (512 slots), 2 steps, no validation; then one T2V request
    of 2 steps at the same size through `python -m
    finetrainers_tpu_torch.inference` with the exported adapter, decoded by the
    faithful VAE. Checks: the base weights bit-equal to the files at load and
    after the run, the LoRA factors a fresh model's at load, the adapter that
    the runner loads bit-equal to the trained factors, each step's launches
    (K1, the pre-pass, K2, K3: the cross calls take 512 UMT5 slots with
    `kv_lens`) and the request's, a finite video of the request's shape.
    Returns the launches by path."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models.text_encoders import T5Handle
    from finetrainers_tpu_torch.models.wan import WanModelSpecification, WanPipeline
    from finetrainers_tpu_torch.models.wan.vae import AutoencoderKLWan

    root = SMOKE_DIR / "wan_local_checkpoint"
    write_s = write_wan_checkpoint(root)
    training_json = SMOKE_DIR / "wan_run_data" / "training.json"
    captions = [f"The video shows a hydraulic press crushing object {i}." for i in range(WAN_RUN_VIDEOS)]
    captions.append(PROMPTS[0])
    tokenizer = _word_tokenizer(root / "tokenizer", captions, 512)
    out_dir = SMOKE_DIR / "wan_checkpoint_run"
    argv = _strip_validation(train_sh_argv(  # no validation: the request below serves the export
        dataset_config=training_json, output_dir=out_dir, report_to="jsonl", train_steps=VIDEO_CKPT_STEPS,
        checkpointing_steps=VIDEO_CKPT_STEPS, precomputation_items=WAN_RUN_VIDEOS, pretrained_model_name_or_path=root,
        tokenizer_id=tokenizer))

    loaded, steps, towers = [], [], []
    orig_load, orig_step, orig_conditions = (WanModelSpecification.load_diffusion_models, SFTTrainer.train_step,
                                             WanModelSpecification.load_condition_models)

    def recording_load(self):
        out = orig_load(self)
        module = out["transformer"].module
        loaded.append(dict(base_equal=_equal_to_files(module, root / "transformer"),
                           lora={n: p.detach().clone() for n, p in module.named_parameters() if ".lora_" in n}))
        return out

    def recording_conditions(self):
        out = orig_conditions(self)
        towers.append((type(out["text_encoder"]).__name__, out["text_encoder"].tokenizer is not None))
        return out

    def counted_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        before, reduce_before, t = _counts(), flash_bwd_dkdv.reduce_launches, time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = orig_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        after = _counts()
        steps.append(dict(seconds=time.perf_counter() - t, launches={k_: after[k_] - before[k_] for k_ in after},
                          reduce=flash_bwd_dkdv.reduce_launches - reduce_before,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        return out

    vae_calls, restore_vae = _timed_vae(AutoencoderKLWan)
    WanModelSpecification.load_diffusion_models, SFTTrainer.train_step = recording_load, counted_step
    WanModelSpecification.load_condition_models = recording_conditions
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        WanModelSpecification.load_diffusion_models, SFTTrainer.train_step = orig_load, orig_step
        WanModelSpecification.load_condition_models = orig_conditions
    spec = trainer.model_specification
    trained = {n: p.detach().clone() for n, p in trainer._trainable.items()}
    base_after = _equal_to_files(trainer.transformer.module, root / "transformer")
    encodes = [c for c in vae_calls if c[0] == "encode"]
    del vae_calls[:]
    log = _jsonl(out_dir)
    precompute_s = next(e["timing/precompute"] for e in log if "timing/precompute" in e)
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    del trainer
    _free_cuda()
    fresh = WanModelSpecification(pretrained_model_name_or_path=str(root / "absent"), device="cuda",
                                  lora_rank=spec.lora_rank, lora_alpha=spec.lora_alpha, seed=spec.seed)
    fresh_lora = {n: p for n, p in fresh.load_diffusion_models()["transformer"].module.named_parameters()
                  if ".lora_" in n}
    lora_fresh = bool(loaded) and loaded[0]["lora"].keys() == fresh_lora.keys() and all(
        torch.equal(v, fresh_lora[n]) for n, v in loaded[0]["lora"].items())
    del fresh, fresh_lora
    _free_cuda()

    adapter = sorted((out_dir / "lora_weights").iterdir())[-1]
    request = dict(prompt=PROMPTS[0], height=WAN_RUN_BUCKET[1], width=WAN_RUN_BUCKET[2], num_frames=WAN_RUN_BUCKET[0])
    served, call = [], WanPipeline.__call__

    def recording_call(self, **kwargs):
        lora = {n: p for n, p in self.transformer.module.named_parameters() if ".lora_" in n}
        served.append(dict(encoder=type(self.text_encoder).__name__, vae=type(self.vae.module).__name__,
                           adapter_bit_equal=lora.keys() == trained.keys() and all(
                               torch.equal(p, trained[n].to(p.dtype)) for n, p in lora.items())))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        video = call(self, **kwargs)
        torch.cuda.synchronize()
        served[-1].update(seconds=time.perf_counter() - t0, launches=_counts(), shape=list(video.shape),
                          finite_std=float(video.std()), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        return video

    serve_argv = ["--model_name", "wan", "--pretrained_model_name_or_path", str(root), "--tokenizer_id",
                  str(tokenizer), "--inference_type", "text_to_video", "--prompt", PROMPTS[0],
                  "--height", str(request["height"]), "--width", str(request["width"]), "--num_frames",
                  str(request["num_frames"]), "--num_inference_steps", str(VIDEO_CKPT_STEPS), "--lora_weights",
                  str(adapter), "--output_dir", str(out_dir / "served")]
    WanPipeline.__call__ = recording_call
    try:
        t0 = time.perf_counter()
        paths = inference.main(serve_argv)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        WanPipeline.__call__ = call
        restore_vae()
    decodes = [c for c in vae_calls if c[0] == "decode"]
    _free_cuda()

    want_step = {k_: WAN_RUN_STEP_LAUNCHES.get(k_, 0) for k_ in _COUNTED}
    steps_ok = len(steps) == VIDEO_CKPT_STEPS and all(st["launches"] == want_step and st["reduce"] == WAN_RUN_REDUCE
                                                      for st in steps)
    request_want = {k_: (2 * WAN_LAYERS * VIDEO_CKPT_STEPS if k_ in ("k1", "prep") else 0) for k_ in _COUNTED}
    s = served[0] if served else {}
    serve_ok = (len(served) == 1 and s["adapter_bit_equal"] and s["launches"] == request_want
                and s["shape"] == [*WAN_RUN_BUCKET, 3] and s["finite_std"] > 0 and s["encoder"] == "T5Handle"
                and s["vae"] == "AutoencoderKLWan" and len(paths) == 1 and len(decodes) == 1)
    checks = dict(base_weights_bit_equal_at_load=bool(loaded) and loaded[0]["base_equal"],
                  base_weights_bit_equal_after_run=base_after, lora_factors_fresh=lora_fresh,
                  towers_loaded=towers == [("T5Handle", True)], steps_launches_exact=steps_ok,
                  losses_finite=len(losses) == VIDEO_CKPT_STEPS and all(np.isfinite(losses)),
                  vae_encoded=len(encodes) > 0, served=serve_ok, jax_imported="jax" in sys.modules)
    phase("wan_checkpoint_run", card=card, entry="python -m finetrainers_tpu_torch.train", argv=[str(a) for a in argv],
          bucket=list(WAN_RUN_BUCKET), write_s=write_s, files_gb=sum(
              f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9, run_s=run_s, precompute_s=precompute_s,
          precompute_s_per_item=precompute_s / WAN_RUN_VIDEOS, vae_encode_calls=len(encodes),
          vae_encode_s=sum(c[1] for c in encodes), vae_encode_input_shapes=sorted({str(c[2]) for c in encodes}),
          step_seconds=[st["seconds"] for st in steps], step_peak_gb=[st["peak_gb"] for st in steps],
          step_launches=steps[0]["launches"] if steps else None,
          step_reduce_passes=steps[0]["reduce"] if steps else None,
          losses=losses, serve_entry="python -m finetrainers_tpu_torch.inference", serve_argv=serve_argv,
          serve_s=serve_s, request=served, vae_decode_s=[c[1] for c in decodes],
          vae_decode_input_shapes=[c[2] for c in decodes], towers=towers, checks=checks)
    if not all(v for k_, v in checks.items() if k_ != "jax_imported") or checks["jax_imported"]:
        raise AssertionError(f"the Wan checkpoint run failed its checks: {checks}")
    shutil.rmtree(root)
    shutil.rmtree(out_dir)
    return {"wan_checkpoint_run": {k_: sum(st["launches"][k_] for st in steps) for k_ in _COUNTED},
            "wan_checkpoint_serve": s["launches"]}


def write_ltx_checkpoint(root):
    """LTX-Video 0.9 as a diffusers directory: `transformer/` at full width cut to LTX_CKPT_BLOCKS of 28 blocks,
    `vae/` AutoencoderKLLTXVideo at its published 0.9.0 config, `text_encoder/` T5-XXL v1.1 at full width cut to
    VIDEO_T5_LAYERS; bf16, random from seeded generators on the card. Returns the write seconds by component."""
    from finetrainers_tpu_torch.models.ltx_video import LTX_TRANSFORMER_CONFIG
    from finetrainers_tpu_torch.models.ltx_video.transformer import LTXVideoTransformer3DModel
    from finetrainers_tpu_torch.models.ltx_video.vae import AutoencoderKLLTXVideo, LTXVAEConfig
    from finetrainers_tpu_torch.models.text_encoders import T5_V1_1_XXL_CONFIG

    g = torch.Generator("cuda").manual_seed(21)
    config = dict(LTX_TRANSFORMER_CONFIG, num_layers=LTX_CKPT_BLOCKS)
    seconds = {}
    with torch.device("cuda"):
        module = init_parameters_(LTXVideoTransformer3DModel(**config, dtype=torch.bfloat16), g)
    seconds["transformer"] = _write_component(root / "transformer", dict(
        config, _class_name="LTXVideoTransformer3DModel"), module, "diffusion_pytorch_model.safetensors")
    del module
    vae_config = dict(dataclasses.asdict(LTXVAEConfig()), _class_name="AutoencoderKLLTXVideo")
    with torch.device("cuda"):
        module = init_parameters_(AutoencoderKLLTXVideo(LTXVAEConfig.from_hf(vae_config), torch.bfloat16), g)
    seconds["vae"] = _write_component(root / "vae", vae_config, module, "diffusion_pytorch_model.safetensors")
    del module
    module = _t5_tower(T5_V1_1_XXL_CONFIG, VIDEO_T5_LAYERS, torch.bfloat16, 22)
    seconds["text_encoder"] = _write_component(root / "text_encoder", dict(
        T5_V1_1_XXL_CONFIG, num_layers=VIDEO_T5_LAYERS), module, "model.safetensors")
    del module
    return config, seconds


def ltx_checkpoint_serve(card):
    """LTX-Video from a local diffusers directory (`write_ltx_checkpoint`)
    through the spec (rank-32 LoRA): base weights bit-equal to the files, the
    LoRA factors a fresh model's, T5 and the faithful VAE loaded; one
    49x512x768 CFG request of 2 steps through `LTXPipeline` whose prompt the
    loaded T5 encodes (stub tokenizer, 128 slots) and whose latents the
    loaded VAE decodes: K1 2 launches a block a step (self and cross). Returns
    the launches."""
    from finetrainers_tpu_torch.models.ltx_video import LTXVideoModelSpecification
    from finetrainers_tpu_torch.models.ltx_video.vae import AutoencoderKLLTXVideo
    from finetrainers_tpu_torch.models.text_encoders import T5Handle

    root = SMOKE_DIR / "ltx_local_checkpoint"
    config, write_s = write_ltx_checkpoint(root)

    def spec_at(path):
        return LTXVideoModelSpecification(pretrained_model_name_or_path=str(path), transformer_config=config,
                                          device="cuda", lora_rank=CKPT_RANK, lora_alpha=CKPT_RANK)

    spec, load_s = spec_at(root), {}
    t0 = time.perf_counter()
    transformer = spec.load_diffusion_models()["transformer"]
    vae = spec.load_latent_models()["vae"]
    text_encoder = spec.load_condition_models()["text_encoder"]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    base_equal = {"transformer": _equal_to_files(transformer.module, root / "transformer"),
                  "vae": _equal_to_files(vae.module, root / "vae"),
                  "text_encoder": isinstance(text_encoder, T5Handle)
                  and _equal_to_files(text_encoder.module, root / "text_encoder")}
    fresh = dict(spec_at(root / "absent").load_diffusion_models()["transformer"].module.named_parameters())
    lora = [n for n, _ in transformer.module.named_parameters() if ".lora_" in n]
    state = dict(transformer.module.named_parameters())
    lora_fresh = bool(lora) and all(torch.equal(state[n], fresh[n]) for n in lora)
    del fresh
    handles_ok = isinstance(vae.module, AutoencoderKLLTXVideo) and isinstance(text_encoder, T5Handle)
    text_encoder.tokenizer = StubTokenizer([24], 32128, pad_id=0, eos_id=1)
    pipe = spec.load_pipeline(transformer=transformer, vae=vae, text_encoder=text_encoder)
    decodes, restore = _timed_vae(AutoencoderKLLTXVideo)
    try:
        pipe(prompt=PROMPTS[0], seed=0, **dict(LTX_CKPT_REQUEST, num_inference_steps=1))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        del decodes[:]
        _zero_counts()
        t0 = time.perf_counter()
        video = pipe(prompt=PROMPTS[0], seed=0, **LTX_CKPT_REQUEST)
        torch.cuda.synchronize()
        request_s, counts = time.perf_counter() - t0, _counts()
    finally:
        restore()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k_: (2 * LTX_CKPT_BLOCKS * VIDEO_CKPT_STEPS if k_ in ("k1", "prep") else 0) for k_ in counts}
    video_ok = (video.shape == (49, 512, 768, 3) and video.dtype == np.uint8 and video.std() > 0)
    phase("ltx_checkpoint_serve", card=card, blocks=LTX_CKPT_BLOCKS, t5_layers=VIDEO_T5_LAYERS, write_s=write_s,
          files_gb=sum(f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9, load_s=load_s,
          base_weights_bit_equal=base_equal, lora_factors_fresh=lora_fresh, lora_tensors=len(lora),
          handles=[type(text_encoder).__name__, type(vae.module).__name__],
          vae_ratios=[vae.config["spatial_compression_ratio"], vae.config["temporal_compression_ratio"]],
          request=dict(LTX_CKPT_REQUEST, steps_note="cut from the request's 50"), request_s=request_s,
          vae_decode_s=[c[1] for c in decodes], vae_decode_input_shapes=[c[2] for c in decodes], peak_gb=peak_gb,
          launches=counts, launches_exact=counts == want, video_shape=list(video.shape), video_std=float(video.std()),
          jax_imported="jax" in sys.modules)
    if not (all(base_equal.values()) and lora_fresh and handles_ok and video_ok and counts == want
            and len(decodes) == 1 and "jax" not in sys.modules):
        raise AssertionError(f"the LTX checkpoint path failed its checks: {base_equal}, LoRA fresh {lora_fresh}, "
                             f"launches {counts}")
    del pipe, transformer, vae, text_encoder, spec
    _free_cuda()
    shutil.rmtree(root)
    return counts


# CogVideoX-5B, HunyuanVideo and FLUX.1-dev from local diffusers directories written here, bf16, seeded: CogVideoX's
# transformer at full width cut to COGVIDEOX_CKPT_BLOCKS of 42 blocks in FAMILY_CKPT_SHARDS shards with an index (the
# whole 42, 11.1 GB, took 84 s on an H100 and put the script's last phase past its budget; the cuts are listed in
# PERF.md section 4),
# HunyuanVideo's and Flux's at full width cut to 2 dual and 2 single blocks (HunyuanVideo's refiner whole), the
# faithful VAEs and Flux's AutoencoderKL whole at their published configs, T5-XXL v1.1 and Llama-3-8B at full width
# cut to 2 layers, CLIP-L's text tower whole.
FAMILY_CKPT_SHARDS, FAMILY_CKPT_BLOCKS, FAMILY_CKPT_STEPS, FAMILY_CKPT_ITEMS = 3, 2, 2, 2
COGVIDEOX_CKPT_BLOCKS = 4
FLUX_AE_CONFIG = dict(in_channels=3, out_channels=3, latent_channels=16, block_out_channels=[128, 256, 512, 512],
                      layers_per_block=2, norm_num_groups=32, use_quant_conv=False, use_post_quant_conv=False,
                      scaling_factor=0.3611, shift_factor=0.1159, _class_name="AutoencoderKL")


def _write_sharded(path, config, module, shards):
    """`module`'s state as `shards` diffusers shards with their index beside `config`; returns the seconds."""
    from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(config))
    state = module.state_dict()
    names, weight_map = list(state), {}
    per = -(-len(names) // shards)
    for i in range(shards):
        file = f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: state[n] for n in names[i * per:(i + 1) * per]}
        safetensors_save_dict(part, str(path / file))
        weight_map.update({n: file for n in part})
    (path / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": weight_map}))
    return time.perf_counter() - t0


def _tower_module(kind, layers, seed):
    """A published tower random on the card in bf16: ("llama" cut to `layers`, or "clip_l" whole), its
    config.json dict and module."""
    from finetrainers_tpu_torch.models.text_encoders import (CLIP_L_TEXT_CONFIG, LLAMA3_8B_CONFIG, CLIPTextConfig,
                                                             CLIPTextTower, DecoderConfig, DecoderTextModel)

    g = torch.Generator("cuda").manual_seed(seed)
    if kind == "llama":
        config = dict(LLAMA3_8B_CONFIG, num_hidden_layers=layers)
        with torch.device("cuda"):
            return config, init_parameters_(DecoderTextModel(DecoderConfig.llama(config), torch.bfloat16), g)
    with torch.device("cuda"):
        return CLIP_L_TEXT_CONFIG, init_parameters_(CLIPTextTower(CLIPTextConfig.from_hf(CLIP_L_TEXT_CONFIG),
                                                                  torch.bfloat16), g)


def _csv_captions(root):
    import csv

    with open(root / "metadata.csv") as f:
        return [row["caption"] for row in csv.DictReader(f)]


def _strip_validation(argv):
    at = argv.index("--validation_dataset_file")
    del argv[at:at + 2]
    return argv


def _timed(fn, *args):
    """(fn(*args), its seconds), synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def recorded_loads(spec_cls, reference, towers_of):
    """Record what `spec_cls` loads while the block runs: each transformer's base
    weights against `reference` (a module holding the written weights, compared
    on the card) or the files under `reference` (a path; None: no check), and its LoRA factors;
    the handle type of each condition slot in `towers_of` and whether it holds
    a tokenizer; the seconds of each load by component (lists, one entry a
    load: the run's, then the runner's)."""
    loaded, towers, seconds = [], [], {"transformer": [], "vae": [], "text_encoders": []}
    originals = (spec_cls.load_diffusion_models, spec_cls.load_latent_models, spec_cls.load_condition_models)

    def recording_load(self):
        out, t = _timed(originals[0], self)
        seconds["transformer"].append(t)
        module = out["transformer"].module
        loaded.append(dict(base_equal=None if reference is None else _base_equal(module, reference),
                           lora={n: p.detach().clone() for n, p in module.named_parameters() if ".lora_" in n}))
        return out

    def recording_latents(self):
        out, t = _timed(originals[1], self)
        seconds["vae"].append(t)
        return out

    def recording_conditions(self):
        out, t = _timed(originals[2], self)
        seconds["text_encoders"].append(t)
        towers.append([(type(out[slot]).__name__, getattr(out[slot], "tokenizer", None) is not None)
                       for slot in towers_of])
        return out

    spec_cls.load_diffusion_models, spec_cls.load_latent_models = recording_load, recording_latents
    spec_cls.load_condition_models = recording_conditions
    try:
        yield loaded, towers, seconds
    finally:
        spec_cls.load_diffusion_models, spec_cls.load_latent_models, spec_cls.load_condition_models = originals


def _base_equal(module, reference):
    """Whether `module`'s base weights are bit-equal to `reference`'s (a module on the card) or to the files under
    `reference` (a path)."""
    if isinstance(reference, pathlib.Path):
        return _equal_to_files(module, reference)
    want = reference.state_dict()
    state = {n: v for n, v in module.state_dict().items() if ".lora_" not in n}
    return state.keys() == want.keys() and all(torch.equal(v, want[n]) for n, v in state.items())


def _fresh_lora(spec_cls, root, spec, **kwargs):
    """The LoRA factors of a fresh model of `spec`'s rank and seed (no directory: its random init)."""
    fresh = spec_cls(pretrained_model_name_or_path=str(root / "absent"), device="cuda", lora_rank=spec.lora_rank,
                     lora_alpha=spec.lora_alpha, seed=spec.seed, **kwargs)
    lora = {n: p.detach().clone() for n, p in fresh.load_diffusion_models()["transformer"].module.named_parameters()
            if ".lora_" in n}
    del fresh
    _free_cuda()
    return lora


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(v, b[n].to(v.dtype)) for n, v in a.items())


def _run_record(rec, log):
    """A checkpoint run's step and precompute figures from `counted_run`'s record and the tracker's log."""
    steps = rec["steps"]
    precompute = {k_: rec["launches"][k_] - sum(st["launches"][k_] for st in steps) for k_ in _COUNTED}
    return dict(run_s=rec["run_s"], precompute_s=next(e["timing/precompute"] for e in log if "timing/precompute" in e),
                load_and_precompute_peak_gb=rec["peaks"].get("load_and_precompute_gb"),
                step_seconds=[st["seconds"] for st in steps], step_peak_gb=[st["peak_gb"] for st in steps],
                step_launches=[st["launches"] for st in steps], step_reduce_passes=[st["reduce"] for st in steps],
                precompute_launches=precompute,
                losses=[e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e])


def write_cogvideox_checkpoint(root):
    """CogVideoX-5B as a diffusers directory: `transformer/` at full width cut to COGVIDEOX_CKPT_BLOCKS of 42 blocks
    in FAMILY_CKPT_SHARDS shards with an index, `vae/` AutoencoderKLCogVideoX at JAX's `CogVideoXVAEConfig`
    defaults, `text_encoder/` T5-XXL v1.1 at full width cut to VIDEO_T5_LAYERS; bf16, random from seeded generators
    on the card. Returns the transformer's config, the written transformer (kept on the card for the bit-equality
    checks) and the write seconds by component."""
    from finetrainers_tpu_torch.models.cogvideox import COGVIDEOX_5B_CONFIG
    from finetrainers_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer3DModel
    from finetrainers_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from finetrainers_tpu_torch.models.text_encoders import T5_V1_1_XXL_CONFIG

    g = torch.Generator("cuda").manual_seed(51)
    config = dict(COGVIDEOX_5B_CONFIG, num_layers=COGVIDEOX_CKPT_BLOCKS)
    seconds = {}
    with torch.device("cuda"):
        transformer = init_parameters_(CogVideoXTransformer3DModel(**config, dtype=torch.bfloat16), g)
    seconds["transformer"] = _write_sharded(root / "transformer", dict(
        config, _class_name="CogVideoXTransformer3DModel"), transformer, FAMILY_CKPT_SHARDS)
    vae_config = dict(dataclasses.asdict(CogVideoXVAEConfig()), _class_name="AutoencoderKLCogVideoX")
    with torch.device("cuda"):
        module = init_parameters_(AutoencoderKLCogVideoX(CogVideoXVAEConfig.from_hf(vae_config), torch.bfloat16), g)
    seconds["vae"] = _write_component(root / "vae", vae_config, module, "diffusion_pytorch_model.safetensors")
    del module
    module = _t5_tower(T5_V1_1_XXL_CONFIG, VIDEO_T5_LAYERS, torch.bfloat16, 52)
    seconds["text_encoder"] = _write_component(root / "text_encoder", dict(
        T5_V1_1_XXL_CONFIG, num_layers=VIDEO_T5_LAYERS), module, "model.safetensors")
    del module
    return config, transformer.eval(), seconds


def cogvideox_checkpoint_run(card):
    """CogVideoX-5B from a local diffusers directory (`write_cogvideox_checkpoint`):
    the crush_smol_lora train.sh's flags (under COGVIDEOX_RUN_POLICY, as
    `cogvideox_run`) through `python -m finetrainers_tpu_torch.train
    --pretrained_model_name_or_path <dir> --tokenizer_id <dir>/tokenizer` on
    `cogvideox_run`'s two videos at 81x480x768 (30,466 tokens), precomputed
    through the faithful VAE (tiled, as the example asks) and T5 (226 slots),
    FAMILY_CKPT_STEPS steps, no validation; then one CFG request of 2 DDIM
    steps at the same size through `python -m finetrainers_tpu_torch.inference`
    with the exported adapter, decoded by the faithful VAE. Checks: the base
    weights bit-equal to the written model at load and after the run, the LoRA
    factors a fresh model's, T5 and its tokenizer loaded, the adapter the
    runner serves bit-equal to the trained factors, each step's launches (K1,
    K2 and K3 once a block, the pre-pass twice, no reduce pass) and the
    request's (K1 and the pre-pass once a block and step, CFG in one batch),
    no launch in precompute (T5
    attends in plain fp32), finite losses and a finite video of the request's
    shape. Returns the launches by path."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models.cogvideox import CogVideoXModelSpecification, CogVideoXPipeline
    from finetrainers_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX

    root = SMOKE_DIR / "cogvideox_local_checkpoint"
    config, written, write_s = write_cogvideox_checkpoint(root)
    data = SMOKE_DIR / "cogvideox_run_data"
    tokenizer = _word_tokenizer(root / "tokenizer", _csv_captions(data) + [PROMPTS[0]], 226)
    out_dir = SMOKE_DIR / "cogvideox_checkpoint_run"
    argv = _strip_validation(train_sh_argv(
        COGVIDEOX_EXAMPLE, dataset_config=data / "training.json", output_dir=out_dir, report_to="jsonl",
        train_steps=FAMILY_CKPT_STEPS, checkpointing_steps=FAMILY_CKPT_STEPS, precomputation_items=FAMILY_CKPT_ITEMS,
        gradient_checkpointing_type=COGVIDEOX_RUN_POLICY, pretrained_model_name_or_path=root, tokenizer_id=tokenizer))
    vae_calls, restore_vae = _timed_vae(AutoencoderKLCogVideoX)
    try:
        with recorded_loads(CogVideoXModelSpecification, written, ["text_encoder"]) as (loaded, towers, load_s), \
                counted_run() as rec:
            trainer = train_cli.main(argv, transformer_config=config)
        spec = trainer.model_specification
        trained = {n: p.detach().clone() for n, p in trainer._trainable.items()}
        base_after = _base_equal(trainer.transformer.module, written)
        del trainer
        _free_cuda()
        run = _run_record(rec, _jsonl(out_dir))
        encodes = [c for c in vae_calls if c[0] == "encode"]
        del vae_calls[:]
        lora_fresh = bool(loaded) and _same(loaded[0]["lora"], _fresh_lora(CogVideoXModelSpecification, root, spec,
                                                                             transformer_config=config))
        del written, spec
        _free_cuda()

        adapter = sorted((out_dir / "lora_weights").iterdir())[-1]
        served, call = [], CogVideoXPipeline.__call__

        def recording_call(self, **kwargs):
            lora = {n: p for n, p in self.transformer.module.named_parameters() if ".lora_" in n}
            served.append(dict(encoder=type(self.text_encoder).__name__, vae=type(self.vae.module).__name__,
                               adapter_bit_equal=_same(lora, trained)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            video = call(self, **kwargs)
            torch.cuda.synchronize()
            served[-1].update(seconds=time.perf_counter() - t0, launches=_counts(), shape=list(video.shape),
                              finite_std=float(video.std()), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            return video

        frames, height, width = COGVIDEOX_BUCKET
        serve_argv = ["--model_name", "cogvideox", "--pretrained_model_name_or_path", str(root), "--tokenizer_id",
                      str(tokenizer), "--inference_type", "text_to_video", "--prompt", PROMPTS[0], "--height",
                      str(height), "--width", str(width), "--num_frames", str(frames), "--num_inference_steps",
                      str(FAMILY_CKPT_STEPS), "--lora_weights", str(adapter), "--output_dir", str(out_dir / "served")]
        CogVideoXPipeline.__call__ = recording_call
        try:
            with recorded_loads(CogVideoXModelSpecification, None, []) as (_, _, serve_load_s):
                t0 = time.perf_counter()
                paths = inference.main(serve_argv, transformer_config=config)
                torch.cuda.synchronize()
                serve_s = time.perf_counter() - t0
        finally:
            CogVideoXPipeline.__call__ = call
    finally:
        restore_vae()
    decodes = [c for c in vae_calls if c[0] == "decode"]
    _free_cuda()

    step_want = dict(k1=COGVIDEOX_CKPT_BLOCKS, prep=2 * COGVIDEOX_CKPT_BLOCKS, k2=COGVIDEOX_CKPT_BLOCKS,
                     k3=COGVIDEOX_CKPT_BLOCKS)
    want_step = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    request_want = {k_: (COGVIDEOX_CKPT_BLOCKS * FAMILY_CKPT_STEPS if k_ in ("k1", "prep") else 0)
                    for k_ in _COUNTED}
    s = served[0] if served else {}
    checks = dict(
        base_weights_bit_equal_at_load=bool(loaded) and loaded[0]["base_equal"],
        base_weights_bit_equal_after_run=base_after, lora_factors_fresh=lora_fresh,
        towers_loaded=towers == [[("T5Handle", True)]],
        steps_launches_exact=len(run["step_launches"]) == FAMILY_CKPT_STEPS and all(
            st == want_step for st in run["step_launches"]) and set(run["step_reduce_passes"]) == {0},
        precompute_launches_exact=all(v == 0 for v in run["precompute_launches"].values()),
        losses_finite=len(run["losses"]) == FAMILY_CKPT_STEPS and all(np.isfinite(run["losses"])),
        vae_encoded=len(encodes) > 0,
        served=(len(served) == 1 and s["adapter_bit_equal"] and s["launches"] == request_want
                and s["shape"] == [frames, height, width, 3] and s["finite_std"] > 0 and s["encoder"] == "T5Handle"
                and s["vae"] == "AutoencoderKLCogVideoX" and len(paths) == 1 and len(decodes) == 1),
        jax_imported="jax" in sys.modules)
    phase("cogvideox_checkpoint_run", card=card, entry="python -m finetrainers_tpu_torch.train",
          argv=[str(a) for a in argv], blocks=COGVIDEOX_CKPT_BLOCKS, bucket=list(COGVIDEOX_BUCKET),
          tokens=COGVIDEOX_TOKENS, write_s=write_s,
          files_gb=sum(f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9,
          transformer_shards=len(list((root / "transformer").glob("*.safetensors"))),
          precompute_s_per_item=run["precompute_s"] / FAMILY_CKPT_ITEMS, vae_encode_calls=len(encodes),
          vae_encode_s=sum(c[1] for c in encodes), vae_encode_input_shapes=sorted({str(c[2]) for c in encodes}),
          load_s=load_s, **run, serve_entry="python -m finetrainers_tpu_torch.inference", serve_argv=serve_argv,
          serve_s=serve_s, serve_load_s=serve_load_s,
          request=served, vae_decode_s=[c[1] for c in decodes], vae_decode_input_shapes=[c[2] for c in decodes],
          towers=towers, checks=checks)
    if not all(v for k_, v in checks.items() if k_ != "jax_imported") or checks["jax_imported"]:
        raise AssertionError(f"the CogVideoX checkpoint run failed its checks: {checks}")
    shutil.rmtree(root)
    shutil.rmtree(out_dir)
    steps_total = {k_: sum(st[k_] for st in run["step_launches"]) for k_ in _COUNTED}
    return {"cogvideox_checkpoint_run": steps_total, "cogvideox_checkpoint_serve": s["launches"]}


def write_hunyuan_checkpoint(root):
    """HunyuanVideo as a diffusers directory: `transformer/` at full width cut to FAMILY_CKPT_BLOCKS dual and
    single blocks of 20 and 40 (the token refiner whole), `vae/` AutoencoderKLHunyuanVideo at its published config,
    `text_encoder/` Llama-3-8B cut to 2 of 32 layers, `text_encoder_2/` CLIP-L's text tower whole; bf16, random
    from seeded generators on the card. Returns the transformer's config and the write seconds by component."""
    from finetrainers_tpu_torch.models.hunyuan_video import HUNYUAN_VIDEO_CONFIG
    from finetrainers_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
    from finetrainers_tpu_torch.models.hunyuan_video.vae import AutoencoderKLHunyuanVideo, HunyuanVAEConfig

    g = torch.Generator("cuda").manual_seed(61)
    config = dict(HUNYUAN_VIDEO_CONFIG, num_layers=FAMILY_CKPT_BLOCKS, num_single_layers=FAMILY_CKPT_BLOCKS)
    seconds = {}
    with torch.device("cuda"):
        module = init_parameters_(HunyuanVideoTransformer3DModel(**config, dtype=torch.bfloat16), g)
    seconds["transformer"] = _write_component(root / "transformer", dict(
        config, _class_name="HunyuanVideoTransformer3DModel"), module, "diffusion_pytorch_model.safetensors")
    del module
    vae_config = dict(dataclasses.asdict(HunyuanVAEConfig()), _class_name="AutoencoderKLHunyuanVideo")
    with torch.device("cuda"):
        module = init_parameters_(AutoencoderKLHunyuanVideo(HunyuanVAEConfig.from_hf(vae_config), torch.bfloat16), g)
    seconds["vae"] = _write_component(root / "vae", vae_config, module, "diffusion_pytorch_model.safetensors")
    del module
    for slot, kind in (("text_encoder", "llama"), ("text_encoder_2", "clip_l")):
        tower_config, module = _tower_module(kind, 2, 62)
        seconds[slot] = _write_component(root / slot, tower_config, module, "model.safetensors")
        del module
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(HUNYUAN_SCHEDULER_CONFIG))
    return config, seconds


def hunyuan_checkpoint_run(card):
    """HunyuanVideo from a local diffusers directory (`write_hunyuan_checkpoint`):
    the modal_labs_dissolve train.sh's flags (its own "ops", which fits at this
    depth) through `python -m finetrainers_tpu_torch.train` with
    `--tokenizer_id` and `--tokenizer_2_id` (word-level tokenizers written
    here) on `hunyuan_run`'s two videos at 49x480x768 (18,976 tokens),
    precomputed through the faithful VAE (tiled, as the example asks), Llama
    (its template) and CLIP-L, FAMILY_CKPT_STEPS steps, no validation (ROADMAP.md
    section 3 finding 14); then the run's first latents decoded through the
    loaded VAE untiled at 49x480x768 (the mid blocks' attention over 74,880
    tokens in chunks of query rows); then the runner on the directory, which
    must refuse before loading the transformer (finding 14). Checks: base
    weights bit-equal to the files at load and after the run, the LoRA factors
    a fresh model's, both towers and their tokenizers loaded, each step's
    launches (K1 6, the pre-pass 12, K2 and K3 6: 4 joint and 2 refiner
    blocks; one reduce pass a refiner block), precompute's (K1's mask branch
    and its pre-pass 2 + 12 an item), finite losses, a finite decode of 49
    frames, the refusal. Returns the launches by path."""
    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models.hunyuan_video import HunyuanVideoModelSpecification
    from finetrainers_tpu_torch.models.hunyuan_video.vae import AutoencoderKLHunyuanVideo
    from finetrainers_tpu_torch.processors.text_encoders import DEFAULT_HUNYUAN_PROMPT_TEMPLATE

    root = SMOKE_DIR / "hunyuan_local_checkpoint"
    config, write_s = write_hunyuan_checkpoint(root)
    data = SMOKE_DIR / "hunyuan_run_data"
    captions = _csv_captions(data) + [PROMPTS[0]]
    tokenizer = _word_tokenizer(root / "tokenizer", captions + [DEFAULT_HUNYUAN_PROMPT_TEMPLATE], 351)
    tokenizer_2 = _word_tokenizer(root / "tokenizer_2", captions, 77)
    out_dir = SMOKE_DIR / "hunyuan_checkpoint_run"
    argv = _strip_validation(train_sh_argv(
        HUNYUAN_EXAMPLE, dataset_config=data / "training.json", output_dir=out_dir, report_to="jsonl",
        train_steps=FAMILY_CKPT_STEPS, checkpointing_steps=FAMILY_CKPT_STEPS, precomputation_items=FAMILY_CKPT_ITEMS,
        pretrained_model_name_or_path=root, tokenizer_id=tokenizer, tokenizer_2_id=tokenizer_2))
    vae_calls, restore_vae = _timed_vae(AutoencoderKLHunyuanVideo)
    try:
        with recorded_loads(HunyuanVideoModelSpecification, root / "transformer",
                            ["text_encoder", "text_encoder_2"]) as (loaded, towers, load_s), counted_run() as rec:
            trainer = train_cli.main(argv, transformer_config=config)
        spec, vae = trainer.model_specification, trainer.vae
        base_after = _base_equal(trainer.transformer.module, root / "transformer")
        del trainer
        _free_cuda()
        run = _run_record(rec, _jsonl(out_dir))
        encodes = [c for c in vae_calls if c[0] == "encode"]
        lora_fresh = bool(loaded) and _same(loaded[0]["lora"], _fresh_lora(
            HunyuanVideoModelSpecification, root, spec, transformer_config=config))
        moments = dict(np.load(out_dir / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz"))["latents"]
        mean = torch.as_tensor(moments, device="cuda")[:, :16]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        with torch.no_grad():
            video = vae.module.decode(mean)  # the moments' mean half: the VAE's own latents, unscaled
        torch.cuda.synchronize()
        decode = dict(seconds=vae_calls[-1][1], input_shape=vae_calls[-1][2], shape=list(video.shape),
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9, resident_gb=base_gb,
                      finite=bool(torch.isfinite(video).all()))
        del video, vae, spec
        _free_cuda()
    finally:
        restore_vae()

    refused, orig_load = {}, HunyuanVideoModelSpecification.load_diffusion_models

    def no_load(self):
        raise AssertionError("the runner loaded the transformer before refusing")

    serve_argv = ["--model_name", "hunyuan_video", "--pretrained_model_name_or_path", str(root), "--tokenizer_id",
                  str(tokenizer), "--tokenizer_2_id", str(tokenizer_2), "--inference_type", "text_to_video",
                  "--prompt", PROMPTS[0], "--height", "480", "--width", "768", "--num_frames", "49",
                  "--num_inference_steps", "2", "--output_dir", str(out_dir / "served")]
    HunyuanVideoModelSpecification.load_diffusion_models = no_load
    try:
        inference.main(serve_argv, transformer_config=config)
    except ValueError as e:
        refused["message"] = str(e)
    finally:
        HunyuanVideoModelSpecification.load_diffusion_models = orig_load
    _free_cuda()

    layers = 2 * FAMILY_CKPT_BLOCKS + HUNYUAN_REFINER_LAYERS
    step_want = dict(k1=layers, prep=2 * layers, k2=layers, k3=layers)
    want_step = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    mask_layers = FAMILY_CKPT_ITEMS * (2 + 12)  # Llama's 2 layers and CLIP-L's 12 an item
    want_precompute = {k_: (mask_layers if k_ in ("k1_mask", "prep") else 0) for k_ in _COUNTED}
    checks = dict(
        base_weights_bit_equal_at_load=bool(loaded) and loaded[0]["base_equal"],
        base_weights_bit_equal_after_run=base_after, lora_factors_fresh=lora_fresh,
        towers_loaded=towers == [[("LlamaHandle", True), ("CLIPTextHandle", True)]],
        steps_launches_exact=len(run["step_launches"]) == FAMILY_CKPT_STEPS and all(
            st == want_step for st in run["step_launches"])
        and run["step_reduce_passes"] == [HUNYUAN_REFINER_LAYERS] * FAMILY_CKPT_STEPS,
        precompute_launches_exact=run["precompute_launches"] == want_precompute,
        losses_finite=len(run["losses"]) == FAMILY_CKPT_STEPS and all(np.isfinite(run["losses"])),
        vae_encoded=len(encodes) > 0,
        decoded=decode["finite"] and decode["shape"] == [1, 3, *HUNYUAN_BUCKET],
        runner_refused="finding 14" in refused.get("message", ""), jax_imported="jax" in sys.modules)
    phase("hunyuan_checkpoint_run", card=card, entry="python -m finetrainers_tpu_torch.train",
          argv=[str(a) for a in argv], blocks=[FAMILY_CKPT_BLOCKS, FAMILY_CKPT_BLOCKS], bucket=list(HUNYUAN_BUCKET),
          tokens=HUNYUAN_TOKENS, write_s=write_s, files_gb=sum(
              f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9,
          precompute_s_per_item=run["precompute_s"] / FAMILY_CKPT_ITEMS, vae_encode_calls=len(encodes),
          vae_encode_s=sum(c[1] for c in encodes), vae_encode_input_shapes=sorted({str(c[2]) for c in encodes}),
          load_s=load_s, **run, decode=decode, runner_refusal=refused, towers=towers, checks=checks)
    if not all(v for k_, v in checks.items() if k_ != "jax_imported") or checks["jax_imported"]:
        raise AssertionError(f"the HunyuanVideo checkpoint run failed its checks: {checks}")
    shutil.rmtree(root)
    shutil.rmtree(out_dir)
    return {"hunyuan_checkpoint_run": {k_: sum(st[k_] for st in run["step_launches"]) for k_ in _COUNTED},
            "hunyuan_checkpoint_precompute": run["precompute_launches"],
            "reduce": sum(run["step_reduce_passes"])}


def write_flux_checkpoint(root):
    """FLUX.1-dev as a diffusers directory: `transformer/` at full width cut to FAMILY_CKPT_BLOCKS dual and single
    blocks of 19 and 38, `vae/` the AutoencoderKL at FLUX.1's 16-channel config whole, `text_encoder/` CLIP-L's
    text tower whole, `text_encoder_2/` T5-XXL v1.1 at full width cut to VIDEO_T5_LAYERS; bf16, random from
    seeded generators on the card. Returns the transformer's config and the write seconds by component."""
    from finetrainers_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from finetrainers_tpu_torch.models.flux.transformer import FluxTransformer2DModel
    from finetrainers_tpu_torch.models.text_encoders import T5_V1_1_XXL_CONFIG

    g = torch.Generator("cuda").manual_seed(71)
    config = dict(FLUX_TRANSFORMER_CONFIG, num_layers=FAMILY_CKPT_BLOCKS, num_single_layers=FAMILY_CKPT_BLOCKS)
    seconds = {}
    with torch.device("cuda"):
        module = init_parameters_(FluxTransformer2DModel(**config, dtype=torch.bfloat16), g)
    seconds["transformer"] = _write_component(root / "transformer", dict(
        config, _class_name="FluxTransformer2DModel"), module, "diffusion_pytorch_model.safetensors")
    del module
    with torch.device("cuda"):
        module = init_parameters_(AutoencoderKL(AutoencoderKLConfig.from_hf(FLUX_AE_CONFIG), torch.bfloat16), g)
    seconds["vae"] = _write_component(root / "vae", FLUX_AE_CONFIG, module, "diffusion_pytorch_model.safetensors")
    del module
    tower_config, module = _tower_module("clip_l", None, 72)
    seconds["text_encoder"] = _write_component(root / "text_encoder", tower_config, module, "model.safetensors")
    del module
    module = _t5_tower(T5_V1_1_XXL_CONFIG, VIDEO_T5_LAYERS, torch.bfloat16, 73)
    seconds["text_encoder_2"] = _write_component(root / "text_encoder_2", dict(
        T5_V1_1_XXL_CONFIG, num_layers=VIDEO_T5_LAYERS), module, "model.safetensors")
    del module
    return config, seconds


def flux_checkpoint_run(card):
    """FLUX.1-dev from a local diffusers directory (`write_flux_checkpoint`):
    the raider_white_tarot train.sh's flags through `python -m
    finetrainers_tpu_torch.train` with `--tokenizer_id` and `--tokenizer_2_id`
    (word-level tokenizers written here) on `flux_run`'s images at 1280x720
    (4112 tokens), FAMILY_CKPT_ITEMS precomputed through the AutoencoderKL and
    CLIP-L (pooled) and T5 (512 slots), FAMILY_CKPT_STEPS steps, no validation
    (ROADMAP.md section 3 finding 14); then the run's first latents decoded
    through the loaded AutoencoderKL. Checks: base weights bit-equal to the
    files at load and after the run, the LoRA factors a fresh model's, both
    towers and their tokenizers loaded, each step's launches (K1 4, the
    pre-pass 8, K2 and K3 4; no reduce pass), precompute's (K1's mask branch
    and its pre-pass 12 an item, CLIP-L's), finite losses, a finite image.
    Returns the launches by path."""
    from finetrainers_tpu_torch import train as train_cli
    from finetrainers_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from finetrainers_tpu_torch.models.autoencoders import decode_image_vae
    from finetrainers_tpu_torch.models.flux import FluxModelSpecification

    root = SMOKE_DIR / "flux_local_checkpoint"
    config, write_s = write_flux_checkpoint(root)
    data = SMOKE_DIR / "flux_run_data"
    captions = _csv_captions(data) + [PROMPTS[0]]
    tokenizer = _word_tokenizer(root / "tokenizer", captions, 77)
    tokenizer_2 = _word_tokenizer(root / "tokenizer_2", captions, 512)
    out_dir = SMOKE_DIR / "flux_checkpoint_run"
    argv = _strip_validation(train_sh_argv(
        FLUX_EXAMPLE, dataset_config=data / "training.json", output_dir=out_dir, report_to="jsonl",
        train_steps=FAMILY_CKPT_STEPS, checkpointing_steps=FAMILY_CKPT_STEPS, precomputation_items=FAMILY_CKPT_ITEMS,
        pretrained_model_name_or_path=root, tokenizer_id=tokenizer, tokenizer_2_id=tokenizer_2))
    vae_calls, restore_vae = _timed_vae(AutoencoderKL)
    try:
        with recorded_loads(FluxModelSpecification, root / "transformer",
                            ["text_encoder", "text_encoder_2"]) as (loaded, towers, load_s), counted_run() as rec:
            trainer = train_cli.main(argv, transformer_config=config)
    finally:
        restore_vae()
    encodes = [c for c in vae_calls if c[0] == "encode"]
    spec, vae = trainer.model_specification, trainer.vae
    base_after = _base_equal(trainer.transformer.module, root / "transformer")
    del trainer
    _free_cuda()
    run = _run_record(rec, _jsonl(out_dir))
    lora_fresh = bool(loaded) and _same(loaded[0]["lora"], _fresh_lora(FluxModelSpecification, root, spec,
                                                                         transformer_config=config))
    moments = dict(np.load(out_dir / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz"))["latents"]
    mean = torch.as_tensor(moments, device="cuda")[:, :16]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    image = decode_image_vae(vae, mean)  # the moments' mean half: the VAE's own latents, unscaled
    torch.cuda.synchronize()
    decode = dict(seconds=time.perf_counter() - t0, input_shape=list(mean.shape), shape=list(image.shape),
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9, finite=bool(torch.isfinite(image).all()),
                  vae=type(vae.module).__name__)
    del image, vae, spec
    _free_cuda()

    step_want = dict(k1=2 * FAMILY_CKPT_BLOCKS, prep=4 * FAMILY_CKPT_BLOCKS, k2=2 * FAMILY_CKPT_BLOCKS,
                     k3=2 * FAMILY_CKPT_BLOCKS)
    want_step = {k_: step_want.get(k_, 0) for k_ in _COUNTED}
    want_precompute = {k_: (FAMILY_CKPT_ITEMS * 12 if k_ in ("k1_mask", "prep") else 0) for k_ in _COUNTED}
    checks = dict(
        base_weights_bit_equal_at_load=bool(loaded) and loaded[0]["base_equal"],
        base_weights_bit_equal_after_run=base_after, lora_factors_fresh=lora_fresh,
        towers_loaded=towers == [[("CLIPTextHandle", True), ("T5Handle", True)]],
        steps_launches_exact=len(run["step_launches"]) == FAMILY_CKPT_STEPS and all(
            st == want_step for st in run["step_launches"]) and set(run["step_reduce_passes"]) == {0},
        precompute_launches_exact=run["precompute_launches"] == want_precompute,
        losses_finite=len(run["losses"]) == FAMILY_CKPT_STEPS and all(np.isfinite(run["losses"])),
        vae_encoded=len(encodes) == FAMILY_CKPT_ITEMS,
        decoded=decode["finite"] and decode["shape"] == [1, 3, FLUX_RUN_BUCKET[0], FLUX_RUN_BUCKET[1]]
        and decode["vae"] == "AutoencoderKL", jax_imported="jax" in sys.modules)
    phase("flux_checkpoint_run", card=card, entry="python -m finetrainers_tpu_torch.train",
          argv=[str(a) for a in argv], blocks=[FAMILY_CKPT_BLOCKS, FAMILY_CKPT_BLOCKS], bucket=list(FLUX_RUN_BUCKET),
          tokens=FLUX_RUN_TOKENS, write_s=write_s, files_gb=sum(
              f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9,
          load_s=load_s, precompute_s_per_item=run["precompute_s"] / FAMILY_CKPT_ITEMS, vae_encode_calls=len(encodes),
          vae_encode_s=sum(c[1] for c in encodes), **run, decode=decode, towers=towers, checks=checks)
    if not all(v for k_, v in checks.items() if k_ != "jax_imported") or checks["jax_imported"]:
        raise AssertionError(f"the Flux checkpoint run failed its checks: {checks}")
    shutil.rmtree(root)
    shutil.rmtree(out_dir)
    return {"flux_checkpoint_run": {k_: sum(st[k_] for st in run["step_launches"]) for k_ in _COUNTED},
            "flux_checkpoint_precompute": run["precompute_launches"]}


def video_dtype_check(card):
    """The towers and VAEs this slice loads, in bf16 against the same weights
    in fp32: UMT5-XXL and T5-XXL v1.1 at full width (2 of 24 layers) on
    captions padded to Wan's 512 and LTX's 128 slots (relative L2 of the
    valid states), and the Wan and LTX VAEs' encode at their published
    configs (relative L2 of the moments' mean half) on a 49-frame clip, Wan's
    at the example's 256-pixel tile, LTX's at 512x768, and likewise
    `AutoencoderKLCogVideoX` and `AutoencoderKLHunyuanVideo` at their examples'
    256-pixel tile. Returns the errors."""
    from finetrainers_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from finetrainers_tpu_torch.models.hunyuan_video.vae import AutoencoderKLHunyuanVideo, HunyuanVAEConfig
    from finetrainers_tpu_torch.models.ltx_video.vae import AutoencoderKLLTXVideo, LTXVAEConfig
    from finetrainers_tpu_torch.models.text_encoders import T5_V1_1_XXL_CONFIG, UMT5_XXL_CONFIG
    from finetrainers_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from finetrainers_tpu_torch.models.weight_utils import load_named_weights

    errors = {}
    for name, config, slots in (("umt5_xxl", UMT5_XXL_CONFIG, 512), ("t5_v1_1_xxl", T5_V1_1_XXL_CONFIG, 128)):
        fp32 = _t5_tower(config, VIDEO_T5_LAYERS, torch.float32, 31)
        with torch.device("cuda"):
            bf16 = type(fp32)(fp32.config, torch.bfloat16).eval()
        load_named_weights(bf16, fp32.state_dict())
        g = torch.Generator("cuda").manual_seed(32)
        ids = torch.randint(3, config["vocab_size"], (2, slots), generator=g, device="cuda")
        mask = torch.zeros((2, slots), dtype=torch.int64, device="cuda")
        mask[0, :40], mask[1, :slots - 7] = 1, 1
        with torch.no_grad():
            want, got = fp32(ids, mask)[mask > 0], bf16(ids, mask).float()[mask > 0]
        errors[name] = ((got - want).norm() / want.norm()).item()
        del fp32, bf16
        _free_cuda()
    for name, cls, cfg, shape in (("wan_vae", AutoencoderKLWan, WanVAEConfig(), (1, 3, 49, 256, 256)),
                                  ("ltx_vae", AutoencoderKLLTXVideo, LTXVAEConfig(), (1, 3, 49, 512, 768)),
                                  ("cogvideox_vae", AutoencoderKLCogVideoX, CogVideoXVAEConfig(), (1, 3, 49, 256, 256)),
                                  ("hunyuan_vae", AutoencoderKLHunyuanVideo, HunyuanVAEConfig(),
                                   (1, 3, 49, 256, 256))):
        with torch.device("cuda"):
            fp32 = init_parameters_(cls(cfg, torch.float32), torch.Generator("cuda").manual_seed(33)).eval()
            bf16 = cls(cfg, torch.bfloat16).eval()
        load_named_weights(bf16, fp32.state_dict())
        x = torch.rand(shape, generator=torch.Generator("cuda").manual_seed(34), device="cuda") * 2 - 1
        with torch.no_grad():
            want = fp32.encode(x).chunk(2, dim=1)[0]
            got = bf16.encode(x).chunk(2, dim=1)[0]
        errors[name] = ((got - want).norm() / want.norm()).item()
        del fp32, bf16, x
        _free_cuda()
    ok = all(v <= (VAE_REL_L2_TOL if k_.endswith("vae") else TOWER_REL_L2_TOL) for k_, v in errors.items())
    phase("video_dtype_check", card=card, rel_l2_bf16_vs_fp32=errors, tower_bound=TOWER_REL_L2_TOL,
          vae_bound=VAE_REL_L2_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"a bf16 tower or VAE strays from fp32: {errors}")
    return errors


def env_phase():
    """Whether the media codecs the data stage decodes with, and transformers' tokenizers (the towers'
    `AutoTokenizer`), import here (information, not a check)."""
    found = {}
    for name in ("cv2", "PIL", "transformers", "tokenizers"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    phase("env", imports=found)


def _kernel_name(mangled):
    """`name<args>` of a mangled kernel, namespaces dropped, e.g.
    `flash_fwd_sm90_kernel<__nv_bfloat16, 128>`; else the mangled name."""
    rest, name, args = mangled[3:] if mangled.startswith("_ZN") else "", None, []
    while m := re.match(r"(\d+)", rest):  # the nested names, each <length><name>; the last is the kernel's
        end = m.end() + int(m.group(1))
        name, rest = rest[m.end():end], rest[end:]
    if name is None:
        return mangled
    if rest.startswith("I"):
        rest = rest[1:]
        while m := re.match(r"L[a-z](\d+)E|(\d+)", rest):
            if m.group(1) is not None:
                args.append(m.group(1))
                rest = rest[m.end():]
            else:
                end = m.end() + int(m.group(2))
                args.append(rest[m.end():end])
                rest = rest[end:]
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_summary(log):
    """Registers and spill bytes of each kernel from nvcc's `-Xptxas=-v` log,
    and its warning lines and notes of a performance loss (such as wgmma
    serialized for want of registers)."""
    kernels, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = _kernel_name(m.group(1))
            kernels[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
    return {"ptxas": kernels, "warnings": [line.strip() for line in log.splitlines()
                                           if "warning" in line.lower() or "performance loss" in line.lower()]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)

    t0 = time.perf_counter()
    sources = _build.SOURCES
    _build.load_libraries(sources)
    builds = {name: {"seconds": _build.BUILD_LOG[name]["seconds"], **ptxas_summary(_build.BUILD_LOG[name]["log"])}
              for name in sources}
    phase("build", seconds=time.perf_counter() - t0, kernels=builds)
    spilled = {name: rec for src in builds.values() for name, rec in src["ptxas"].items()
               if name.startswith(NO_SPILL_KERNELS) and (rec.get("spill_stores") or rec.get("spill_loads"))}
    if spilled:
        raise AssertionError(f"a kernel of NO_SPILL_KERNELS spills registers: {spilled}")

    k1_err, k1 = check_k1(card)
    bwd_err, bwd = check_k2k3(card)
    k6_err, prep_err, k6 = check_k6(card)
    k1_wan_err, k1_wan = check_k1_wan(card)
    k5_err, k5 = check_k5(card)
    k5_wan, k5_ltx = k5["wan_self_shared_rope"], k5["ltx_self_rope"]
    k7_err, k7_by_case = check_k7(card)
    k7_main = {"k7a": "wan_train_self_shared_rope", "k7b": "wan_train_cross_kv_lens",
               "k7c": "wan_train_self_shared_rope"}  # each kernel at the shape the Wan training path gives it
    k7 = {key: dict(k7_by_case[key][case], by_case=k7_by_case[key]) for key, case in k7_main.items()}
    k1_mask_err, k1_mask = check_k1_mask(card)
    branch_err, branch_records, branch_launches, variant_records = check_attention_branches(card)
    torch.cuda.empty_cache()
    serve_launches = serve(card)
    torch.cuda.empty_cache()
    wan_sage_launches, wan_auto_launches = wan_serve(card)
    torch.cuda.empty_cache()
    train_launches = train(card)
    torch.cuda.empty_cache()
    wan_paths = wan_train(card)
    torch.cuda.empty_cache()
    wan_paths.update(wan_train_accum_resume(card))
    torch.cuda.empty_cache()
    wan_paths.update(wan_run(card))
    _free_cuda()
    i2v_train = wan_i2v_train(card)
    i2v_serve_launches, _ = wan_i2v_serve(card, i2v_train["adapter"])
    i2v_branch_launches, i2v_branch_in_step = wan_i2v_image_branch(card)
    flux_k1_err, flux_k1, flux_bwd_err, flux_bwd = check_flux_kernels(card)
    flux = flux_run(card)
    flux_serve_launches, flux_serve_in_step = flux_serve(card, flux["adapter"])
    hy_k1_err, hy_k1, hy_bwd_err, hy_bwd = check_hunyuan_kernels(card)
    hunyuan = hunyuan_run(card)
    hy_serve_launches, hy_serve_in_step = hunyuan_serve(card, hunyuan["adapter"])
    cv_k1_err, cv_k1, cv_bwd_err, cv_bwd = check_cogview4_kernels(card)
    cogview4 = cogview4_control_run(card)
    cv_serve = cogview4_serve(card, cogview4["adapter"], cogview4["edge_map"])
    wan_control = wan_control_run(card)
    cx_k1_err, cx_k1, cx_bwd_err, cx_bwd = check_cogvideox_kernels(card)
    cogvideox = cogvideox_run(card)
    cx_serve_launches, cx_serve_in_step = cogvideox_serve(card, cogvideox["adapter"])
    h32 = check_h32_kernels(card)
    (h32_k1_err, h32_k1), (h32_bwd_err, h32_bwd) = h32["k1"], h32["bwd"]
    dummy = dummy_run(card)
    dummy_serve_launches = dummy_serve(card, dummy["adapter"])
    raider = cogview4_sft_run(card)
    raider_serve = cogview4_sft_serve(card, raider["adapter"])
    tower_launches = text_towers(card)
    checkpoint_launches, checkpoint_runner = cogview4_checkpoint_serve(card)
    video_launches = wan_checkpoint_run(card)
    video_launches["ltx_checkpoint_serve"] = ltx_checkpoint_serve(card)
    video_launches.update(cogvideox_checkpoint_run(card))
    hy_ckpt = hunyuan_checkpoint_run(card)
    flux_ckpt = flux_checkpoint_run(card)
    video_launches.update(hunyuan_checkpoint_run=hy_ckpt["hunyuan_checkpoint_run"],
                          flux_checkpoint_run=flux_ckpt["flux_checkpoint_run"])
    video_dtype_check(card)
    shutil.rmtree(SMOKE_DIR)
    env_phase()

    def entry(name, source, replaces, launches, err, record, **extra):
        ms, plain_ms, library_ms, bound_ms, bound_by = record
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, **extra)

    def wan_shape(record):  # a K1 record of check_k5 at Wan's training shape (no plain version timed there)
        ms, _, library_ms, bound_ms, bound_by = record
        return dict(shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128], ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by)

    def ptxas(source, kernel):  # the registers and spill bytes of `kernel`'s instantiations
        return {name: rec for name, rec in builds[source]["ptxas"].items() if name.startswith(kernel + "<")}

    def k7_entry(key, name, replaces, kernel, c_entry):
        r, launches = k7[key], wan_paths[f"wan_train_{key}"][key]
        return entry(name, "finetrainers_tpu_torch/csrc/flash_fwd_sm90.cu", replaces, launches, k7_err[key],
                     (r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"]),
                     launches_by_path={f"wan_train_{key}": launches},
                     by_case=r["by_case"], library_note="torch SDPA forward, without the fused rotation",
                     entry_point=c_entry, ptxas=ptxas("flash_fwd_sm90", kernel))

    def bwd_entry(key, name, replaces):  # K2 or K3: the Wan training self-attention case, the others by case
        fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        extra = {}
        if key == "k2":  # the reduce pass: its launches on the paths that count them, its records where it ran
            extra = dict(reduce_launches_by_path={"hunyuan_run": hunyuan["reduce"],
                                                  "hunyuan_checkpoint_run": hy_ckpt["reduce"],
                                                  "cogview4_control_run": cogview4["reduce"],
                                                  "wan_control_run": wan_control["reduce"],
                                                  "cogvideox_run": cogvideox["reduce"]},
                         reduce_in_step_ms={"hunyuan_run": hunyuan["in_step"]["k2_reduce"]},
                         reduce_by_case={case: dict(zip(fields, r["reduce"])) for case, r in
                                         {**bwd, **flux_bwd, **hy_bwd, **cv_bwd, **cx_bwd}.items()
                                         if r["reduce"] is not None})
        return entry(name, "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu", replaces, wan[key],
                     max(bwd_err[key], flux_bwd_err[key], hy_bwd_err[key], cv_bwd_err[key], cx_bwd_err[key]),
                     bwd["wan_train_self_shared_rope"][key],
                     launches_by_path={"train": train_launches[key], "wan_train": wan[key],
                                       **{f"wan_train_{p}": wan_paths[f"wan_train_{p}"][key]
                                          for p in ("ops", "ops_attn", "ops_narrow", "accum")},
                                       **{path: wan_paths[path][key] for path in WAN_RUN_PATHS},
                                       "wan_i2v_train": i2v_train["launches"][key], "flux_run": flux["launches"][key],
                                       "hunyuan_run": hunyuan["launches"][key],
                                       "cogview4_control_run": cogview4["launches"][key],
                                       "wan_control_run": wan_control["launches"][key],
                                       "cogvideox_run": cogvideox["launches"][key],
                                       **{path: video_launches[path][key] for path in (
                                           "wan_checkpoint_run", "cogvideox_checkpoint_run", "hunyuan_checkpoint_run",
                                           "flux_checkpoint_run")}},
                     shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128],
                     i2v_train_in_step_ms={part: i2v_train["in_step"][f"{key}_{part}"] for part in ("self", "cross")},
                     flux_train_in_step_ms=flux["in_step"][key],
                     hunyuan_train_in_step_ms=dict(zip(("joint", "refiner"), hunyuan["in_step"][key])),
                     cogview4_train_in_step_ms=cogview4["in_step"][key],
                     cogvideox_train_in_step_ms=cogvideox["in_step"][key],
                     device_ms=bwd["wan_train_self_shared_rope"][f"{key}_device_ms"],
                     by_case={case: dict(zip(fields, r[key]), device_ms=r[f"{key}_device_ms"])
                              for case, r in {**bwd, **flux_bwd, **hy_bwd, **cv_bwd, **cx_bwd}.items()},
                     library_note="torch SDPA backward (dq, dk, dv in one call), without the fused rotation", **extra)

    def h32_entry(key, name, source, replaces, err, record, **extra):
        """A head-dim-32 instance: its launches on the dummy paths that run it (the first of them is the
        entry's `launches`), timed at the dummy's self-attention."""
        paths = {f"dummy_{run}_run": dummy[run]["launches"][key]
                 for run in ("lora", "full_finetune_adamw_8bit", *DUMMY_SWITCH_RUNS)}
        paths.update({"dummy_serve" + ("" if provider == "auto" else f"_{provider}"): n[key]
                      for provider, n in dummy_serve_launches.items()})
        launches = {path: n for path, n in paths.items() if n}
        return entry(name, source, replaces, next(iter(launches.values()), 0), err, record, head_dim=32,
                     shape=[1, DUMMY_HEADS, DUMMY_TOKENS, DUMMY_TOKENS, 32], launches_by_path=launches, **extra)

    def h32_instances(source, kernel):  # the head-dim-32 instantiations of `kernel`
        return {n: rec for n, rec in ptxas(source, kernel).items() if re.search(r"<[^,>]+, 32[,>]", n)}

    def branch_entry(kernel, branch, replaces, also_replaces, headline, h=128):
        """A branch of K1, K2 or K3 (its instances at head dims 64 and 128, or with `h` 32 at 32): timed at its
        headline case of `check_attention_branches`, its launches there by case."""
        cases = [c for c, r in branch_records.items() if r["branch"] == branch and (r["shape"][4] == 32) == (h == 32)]
        key = "k1_mask" if (kernel, branch) == ("k1", "mask") else f"{kernel}_{branch}"
        errs = [r["k1_vs_plain"]["max_abs_err"] if kernel == "k1" else
                max(r["bwd_vs_plain"][g]["max_abs_err"] for g in (("dq",) if kernel == "k3" else ("dk", "dv")))
                for c, r in branch_records.items() if c in cases]
        r = branch_records[headline]
        bound_ms, bound_by = r[f"{kernel}_bound"]
        plain, library = (r["plain_ms"], r["sdpa_ms"]) if kernel == "k1" else (r["plain_backward_ms"],
                                                                                r["sdpa_backward_ms"])
        side = "fwd" if kernel == "k1" else "bwd"
        code = {"causal": 1, "segment": 2, "mask": 3}[branch]
        kernel_name = {"k1": BRANCH_KERNELS[branch], "k2": f"bwd_dkdv_sm90_kernel<T, H, {code}>",
                       "k3": f"bwd_dq_sm90_kernel<T, H, {code}>"}[kernel]
        instances = {n: rec for n, rec in ptxas(f"flash_{side}_branches_sm90", kernel_name.split("<")[0]).items()
                     if (kernel == "k1" or n.endswith(f", {code}>")) and (", 32" in n) == (h == 32)}
        return entry(f"{kernel_name} ({kernel.upper()}'s {branch} branch, wgmma + TMA"
                     + (", head dim 32)" if h == 32 else ")"),
                     f"finetrainers_tpu_torch/csrc/flash_{side}_branches_sm90.cu",
                     f"finetrainers_tpu/ops/flash_attention.py:{replaces}", branch_launches[headline].get(key, 0),
                     max(errs), (r[f"{kernel}_ms"], plain, library, bound_ms, bound_by),
                     also_replaces=[f"finetrainers_tpu/ops/flash_attention.py:{line}" for line in also_replaces],
                     kernel_source=f"finetrainers_tpu_torch/csrc/flash_{side}_sm90.cu",
                     ptxas=instances,
                     shape=r["shape"], headline_case=headline, device_ms=r[f"{kernel}_device_ms"], head_dim=h,
                     launches_by_path={f"attention_branches_{c}": branch_launches[c].get(key, 0) for c in cases},
                     by_case={c: dict(ms=branch_records[c][f"{kernel}_ms"],
                                      device_ms=branch_records[c][f"{kernel}_device_ms"],
                                      bound_ms=branch_records[c][f"{kernel}_bound"][0],
                                      library_ms=branch_records[c]["sdpa_ms" if kernel == "k1" else
                                                                 "sdpa_backward_ms"]) for c in cases},
                     plain_note=("the plain forward" if kernel == "k1" else
                                 "the plain backward (K2's and K3's plain versions together)") + ", head by head",
                     bound_note="over the live (query, key) pairs only",
                     library_note="torch SDPA " + ("forward" if kernel == "k1" else "backward (dq, dk, dv)")
                                  + " given the same mask (is_causal where Sq = Skv)")

    def variant_branch_entry(key, branch, headline, replaces, also_replaces, kernel_name, extra_paths=(), h=128):
        """A branch of K7a, K7b, K7c or K5 (its instances at head dims 64 and 128, or with `h` 32 at 32): timed
        at its headline case of `check_variant_branches`, its launches there by case (each case's run through
        the dispatcher under the switch)."""
        sw = {"k7a": "FINETRAINERS_FLASH_TWOPASS", "k7b": "FINETRAINERS_FLASH_SKEW",
              "k7c": "FINETRAINERS_FLASH_TWOLEVEL", "k5": "FINETRAINERS_FLASH_FUSED_BWD"}[key]
        cases = [c for c, r in variant_records.items() if sw in r and branch_records[c]["branch"] == branch
                 and (branch_records[c]["shape"][4] == 32) == (h == 32)]
        count = f"{key}_{branch}"
        errs = [variant_records[c][sw]["vs_plain"]["max_abs_err"] if key != "k5" else
                max(variant_records[c][sw]["bwd_vs_plain"][g]["max_abs_err"] for g in ("dq", "dk", "dv"))
                for c in cases]
        r = variant_records[headline][sw]
        library = "flash_bwd_fused_branches_sm90" if key == "k5" else "flash_fwd_variant_branches_sm90"
        code = {"causal": 1, "segment": 2, "mask": 3}[branch]
        instances = {n: rec for n, rec in ptxas(library, kernel_name).items()
                     if (key != "k5" or n.endswith(f", {code}>")) and (", 32" in n) == (h == 32)}
        beside = ("k2_k3_branch_ms", "k2_k3_branch_device_ms") if key == "k5" else ("k1_branch_ms",
                                                                                     "k1_branch_device_ms")
        return entry(f"{kernel_name} ({key.upper()}'s {branch} branch, wgmma + TMA"
                     + (", head dim 32)" if h == 32 else ")"),
                     f"finetrainers_tpu_torch/csrc/{library}.cu", f"finetrainers_tpu/ops/flash_attention.py:{replaces}",
                     r["launches"].get(count, 0), max(errs), tuple(r[f] for f in fields),
                     also_replaces=[f"finetrainers_tpu/ops/flash_attention.py:{line}" for line in also_replaces],
                     kernel_source="finetrainers_tpu_torch/csrc/" + ("flash_bwd_sm90.cu" if key == "k5"
                                                                     else "flash_fwd_sm90.cu"),
                     ptxas=instances, switch=sw, shape=branch_records[headline]["shape"], headline_case=headline,
                     head_dim=h,
                     device_ms=r["device_ms"], **{f: r[f] for f in beside},
                     launches_by_path={**{f"variant_branches_{c}": variant_records[c][sw]["launches"].get(count, 0)
                                          for c in cases}, **dict(extra_paths)},
                     by_case={c: {f: variant_records[c][sw][f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                                          "library_ms", *beside)} for c in cases},
                     plain_note=("its plain version" + ("" if key == "k5" else " (the forward)") + ", whole"),
                     bound_note="over the live (query, key) pairs only",
                     library_note="torch SDPA " + ("backward (dq, dk, dv)" if key == "k5" else "forward")
                                  + " given the same mask (is_causal where Sq = Skv)")

    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    h32_self = h32_k1["dummy_self"]
    wan = wan_paths["wan_train"]
    ltx_self = k1["self_rope"]
    print(json.dumps({"kernels": [
        entry("flash_fwd_sm90 (K1, wgmma + TMA, on the pre-pass's operands)",
              "finetrainers_tpu_torch/csrc/flash_fwd_sm90.cu", "finetrainers_tpu/ops/flash_attention.py:106",
              serve_launches["k1"], max(k1_err, k1_wan_err, flux_k1_err, hy_k1_err, cv_k1_err, cx_k1_err),
              (ltx_self["ms"], ltx_self["plain_ms"], ltx_self["library_ms"], ltx_self["bound_ms"],
               ltx_self["bound_by"]),
              launches_by_path={"serve": serve_launches["k1"], "train": train_launches["k1"],
                                "wan_serve_default_provider": wan_auto_launches["k1"], "wan_train": wan["k1"],
                                **{f"wan_train_{key}": wan_paths[f"wan_train_{key}"]["k1"]
                                   for key in WAN_PATH_KEYS},
                                **{path: wan_paths[path]["k1"] for path in WAN_RUN_PATHS},
                                "wan_i2v_train": i2v_train["launches"]["k1"],
                                "wan_i2v_serve": i2v_serve_launches["k1"],
                                "wan_i2v_image_branch": i2v_branch_launches["auto"]["k1"],
                                "flux_run": flux["launches"]["k1"], "flux_serve": flux_serve_launches["k1"],
                                "hunyuan_run": hunyuan["launches"]["k1"], "hunyuan_serve": hy_serve_launches["k1"],
                                "cogview4_control_run": cogview4["launches"]["k1"],
                                **{f"cogview4_serve_{name}": r["launches"]["k1"] for name, r in cv_serve.items()},
                                "wan_control_run": wan_control["launches"]["k1"],
                                "cogvideox_run": cogvideox["launches"]["k1"],
                                "cogvideox_serve": cx_serve_launches["k1"],
                                **{path: n["k1"] for path, n in video_launches.items()}},
              shape=[2, 32, 2688, 2688, 64], by_case={**k1, **k1_wan, **flux_k1, **hy_k1, **cv_k1, **cx_k1},
              flux_in_step_ms=dict(serve_self=flux_serve_in_step["k1"], train_self=flux["in_step"]["k1"]),
              hunyuan_in_step_ms=dict(serve=dict(zip(("joint", "refiner"), hy_serve_in_step["k1"])),
                                      train=dict(zip(("joint", "refiner"), hunyuan["in_step"]["k1"]))),
              cogview4_in_step_ms=dict(train=cogview4["in_step"]["k1"],
                                       **{f"serve_{name}": r["in_step"]["k1"] for name, r in cv_serve.items()}),
              cogvideox_in_step_ms=dict(train=cogvideox["in_step"]["k1"], serve=cx_serve_in_step["k1"]),
              i2v_in_step_ms=dict(i2v_branch_in_step["auto"], train_self=i2v_train["in_step"]["k1_self"],
                                  train_cross=i2v_train["in_step"]["k1_cross"]),
              wan_train_self_attention=wan_shape(k5_wan["k1"]),
              library_note="torch SDPA forward, without the fused rotation"),
        entry("flash_qk_prep (the RoPE and q-scale pre-pass before K1, K7a, K7c, K2/K3 and K5)",
              "finetrainers_tpu_torch/csrc/flash_bwd.cu", "finetrainers_tpu/ops/flash_attention.py:189",
              serve_launches["prep"], max(bwd_err["prep"], flux_bwd_err["prep"], hy_bwd_err["prep"],
                                          cv_bwd_err["prep"], cx_bwd_err["prep"]),
              bwd["self_rope"]["prep"],
              also_replaces=["finetrainers_tpu/ops/flash_attention.py:961",
                             "finetrainers_tpu/ops/flash_attention.py:1268"],
              launches_by_path={"serve": serve_launches["prep"], "train": train_launches["prep"],
                                "wan_serve_default_provider": wan_auto_launches["prep"], "wan_train": wan["prep"],
                                **{f"wan_train_{key}": wan_paths[f"wan_train_{key}"]["prep"]
                                   for key in WAN_PATH_KEYS},
                                **{path: wan_paths[path]["prep"] for path in WAN_RUN_PATHS},
                                "wan_i2v_train": i2v_train["launches"]["prep"],
                                "wan_i2v_serve": i2v_serve_launches["prep"],
                                "wan_i2v_image_branch": i2v_branch_launches["auto"]["prep"],
                                "flux_run": flux["launches"]["prep"], "flux_serve": flux_serve_launches["prep"],
                                "hunyuan_run": hunyuan["launches"]["prep"],
                                "hunyuan_serve": hy_serve_launches["prep"],
                                "cogview4_control_run": cogview4["launches"]["prep"],
                                **{f"cogview4_serve_{name}": r["launches"]["prep"] for name, r in cv_serve.items()},
                                "wan_control_run": wan_control["launches"]["prep"],
                                "cogvideox_run": cogvideox["launches"]["prep"],
                                "cogvideox_serve": cx_serve_launches["prep"],
                                **{path: n["prep"] for path, n in video_launches.items()},
                                "hunyuan_checkpoint_run_precompute": hy_ckpt["hunyuan_checkpoint_precompute"]["prep"],
                                "flux_checkpoint_run_precompute": flux_ckpt["flux_checkpoint_precompute"]["prep"]},
              flux_by_case={case: dict(ms=r["prep_ms"], plain_ms=r["prep_plain_ms"]) for case, r in flux_k1.items()},
              flux_in_step_ms=dict(serve=flux_serve_in_step["prep"], train=flux["in_step"]["prep"]),
              hunyuan_by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["prep"]))
                               for case, r in hy_bwd.items()},
              hunyuan_in_step_ms=dict(serve=dict(zip(("joint", "refiner"), hy_serve_in_step["prep"])),
                                      train=dict(zip(("joint", "refiner"), hunyuan["in_step"]["prep"]))),
              cogview4_by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["prep"]))
                                for case, r in cv_bwd.items()},
              cogview4_forward_by_case={case: dict(ms=r["prep_ms"], plain_ms=r["prep_plain_ms"])
                                        for case, r in cv_k1.items()},
              cogview4_in_step_ms=dict(train=cogview4["in_step"]["prep"],
                                       **{f"serve_{name}": r["in_step"]["prep"] for name, r in cv_serve.items()}),
              cogvideox_by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["prep"]))
                                 for case, r in cx_bwd.items()},
              cogvideox_forward_by_case={case: dict(ms=r["prep_ms"], plain_ms=r["prep_plain_ms"])
                                         for case, r in cx_k1.items()},
              cogvideox_in_step_ms=dict(train=cogvideox["in_step"]["prep"], serve=cx_serve_in_step["prep"]),
              shape_note="timed at LTX's train self-attention (1, 32, 2688, 64) with per-head tables"),
        bwd_entry("k2", "bwd_dkdv_sm90 (K2, wgmma + TMA, with its reduce pass where the q loop is split)",
                  "finetrainers_tpu/ops/flash_attention.py:888"),
        bwd_entry("k3", "bwd_dq_sm90 (K3, wgmma + TMA)", "finetrainers_tpu/ops/flash_attention.py:1199"),
        entry("bwd_fused_sm90 (K5, wgmma + TMA, dq added by TMA reduces)",
              "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu",
              "finetrainers_tpu/ops/flash_attention.py:1038", wan_paths["wan_train_fused_bwd"]["k5"], k5_err["k5"],
              k5_wan["k5"], launches_by_path={"wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["k5"]},
              shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128], fused_backward_ms=k5_wan["fused_backward_ms"],
              ptxas=ptxas("flash_bwd_sm90", "bwd_fused_sm90_kernel"),
              ltx_train_self_attention=dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                                k5_ltx["k5"])),
              library_note="torch SDPA backward (dq, dk, dv), without the fused rotation"),
        entry("bwd_fused dq emit (K5's scale, transpose rotation and cast of dq)",
              "finetrainers_tpu_torch/csrc/flash_bwd.cu", "finetrainers_tpu/ops/flash_attention.py:1191",
              wan_paths["wan_train_fused_bwd"]["k5_emit"], k5_err["k5_emit"], k5_wan["k5_emit"],
              launches_by_path={"wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["k5_emit"]}),
        k7_entry("k7a", "flash_fwd_twopass_sm90 (K7a, wgmma + TMA, on the pre-pass's operands)",
                 "finetrainers_tpu/ops/flash_attention.py:337", "flash_fwd_twopass_sm90_kernel",
                 "flash_fwd_twopass_sm90"),
        k7_entry("k7b", "flash_fwd_skew_sm90 (K7b, wgmma + TMA, q scaled in shared memory, 64-key score tiles)",
                 "finetrainers_tpu/ops/flash_attention.py:491", "flash_fwd_skew_sm90_kernel", "flash_fwd_skew_sm90"),
        k7_entry("k7c", "flash_fwd_two_level_sm90 (K7c, wgmma + TMA, on the pre-pass's operands)",
                 "finetrainers_tpu/ops/flash_attention.py:229", "flash_fwd_two_level_sm90_kernel",
                 "flash_fwd_two_level_sm90"),
        entry("sage_fwd_sm90 (K6, int8 wgmma + TMA, on the pre-pass's codes)",
              "finetrainers_tpu_torch/csrc/sage_fwd_sm90.cu", "finetrainers_tpu/ops/sage_attention.py:36",
              wan_sage_launches["k6"], k6_err, k6["wan_self_rope"]["k6"], shape=[2, 12, WAN_TOKENS, WAN_TOKENS, 128],
              launches_by_path={"wan_serve": wan_sage_launches["k6"],
                                "wan_i2v_image_branch": i2v_branch_launches["sage"]["k6"]},
              i2v_in_step_ms=i2v_branch_in_step["sage"],
              by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["k6"]))
                       for case, r in k6.items()},
              library_note="torch SDPA on the unquantized, unrotated bf16 inputs: a yardstick only"),
        entry("sage_prep (rotation, smooth-K and int8 quantization of q and k before K6)",
              "finetrainers_tpu_torch/csrc/sage_fwd_sm90.cu", "finetrainers_tpu/ops/sage_attention.py:112",
              wan_sage_launches["sage_prep"], prep_err, k6["wan_self_rope"]["prep"],
              launches_by_path={"wan_serve": wan_sage_launches["sage_prep"],
                                "wan_i2v_image_branch": i2v_branch_launches["sage"]["sage_prep"]},
              also_replaces=["finetrainers_tpu/ops/attention.py:121"], shape=[2, 12, WAN_TOKENS, WAN_TOKENS, 128],
              by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["prep"]))
                       for case, r in k6.items()},
              max_abs_err_note="the largest difference of an int8 code from the plain pre-pass on the CPU",
              plain_note="the plain pre-pass on the card: torch's rotation and quantization, the path before it"),
        h32_entry("k1", "flash_fwd_sm90 at head dim 32 (K1, wgmma + TMA, 64-byte rows under the 64-byte swizzle)",
                  "finetrainers_tpu_torch/csrc/flash_fwd_sm90.cu", "finetrainers_tpu/ops/flash_attention.py:106",
                  h32_k1_err, tuple(h32_self[f] for f in fields),
                  by_case={case: {f: r[f] for f in fields} for case, r in h32_k1.items()},
                  bound_note="the larger of bytes, tensor operations and exponentials (one exp2 a score at the SFU's "
                             "3.865e12/s; at head dim 32 it is the exponentials wherever operations bound)",
                  library_note="torch SDPA forward"),
        h32_entry("prep", "flash_qk_prep at head dim 32 (the pre-pass)", "finetrainers_tpu_torch/csrc/flash_bwd.cu",
                  "finetrainers_tpu/ops/flash_attention.py:189", h32_bwd_err["prep"], h32_bwd["dummy_self"]["prep"],
                  by_case={case: dict(zip(fields, r["prep"])) for case, r in h32_bwd.items()}),
        h32_entry("k2", "bwd_dkdv_sm90 at head dim 32 (K2, wgmma + TMA, with its reduce pass)",
                  "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu", "finetrainers_tpu/ops/flash_attention.py:888",
                  h32_bwd_err["k2"], h32_bwd["dummy_self"]["k2"],
                  by_case={case: dict(zip(fields, r["k2"]), device_ms=r["k2_device_ms"]) for case, r in h32_bwd.items()},
                  reduce_launches_by_path={"dummy_lora_run": dummy["lora"]["reduce"],
                                           "dummy_full_finetune_run": dummy["full_finetune_adamw_8bit"]["reduce"]},
                  reduce_by_case={case: dict(zip(fields, r["reduce"])) for case, r in h32_bwd.items()
                                  if r["reduce"] is not None},
                  library_note="torch SDPA backward (dq, dk, dv in one call)"),
        h32_entry("k3", "bwd_dq_sm90 at head dim 32 (K3, wgmma + TMA)", "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu",
                  "finetrainers_tpu/ops/flash_attention.py:1199", h32_bwd_err["k3"], h32_bwd["dummy_self"]["k3"],
                  by_case={case: dict(zip(fields, r["k3"]), device_ms=r["k3_device_ms"]) for case, r in h32_bwd.items()},
                  library_note="torch SDPA backward (dq, dk, dv in one call)"),
        h32_entry("k5", "bwd_fused_sm90 at head dim 32 (K5, wgmma + TMA, a 64 x 32 dq tile a warpgroup)",
                  "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu", "finetrainers_tpu/ops/flash_attention.py:1038",
                  h32["k5"][0]["k5"], h32["k5"][1]["dummy_self"]["k5"],
                  by_case={case: dict(zip(fields, r["k5"])) for case, r in h32["k5"][1].items()},
                  ptxas=h32_instances("flash_bwd_sm90", "bwd_fused_sm90_kernel"),
                  library_note="torch SDPA backward (dq, dk, dv in one call)"),
        h32_entry("k5_emit", "bwd_fused dq emit at head dim 32", "finetrainers_tpu_torch/csrc/flash_bwd.cu",
                  "finetrainers_tpu/ops/flash_attention.py:1191", h32["k5"][0]["k5_emit"],
                  h32["k5"][1]["dummy_self"]["k5_emit"],
                  by_case={case: dict(zip(fields, r["k5_emit"])) for case, r in h32["k5"][1].items()}),
        *[h32_entry(key, f"{c_entry} at head dim 32 ({key.upper()}, wgmma + TMA)",
                    "finetrainers_tpu_torch/csrc/flash_fwd_sm90.cu", f"finetrainers_tpu/ops/flash_attention.py:{line}",
                    h32["k7"][0][key], tuple(h32["k7"][1][key]["dummy_self"][f] for f in fields),
                    by_case={case: {f: r[f] for f in fields} for case, r in h32["k7"][1][key].items()},
                    ptxas=h32_instances("flash_fwd_sm90", f"{c_entry}_kernel"), library_note="torch SDPA forward")
          for key, c_entry, line in (("k7a", "flash_fwd_twopass_sm90", 337), ("k7b", "flash_fwd_skew_sm90", 491),
                                     ("k7c", "flash_fwd_two_level_sm90", 229))],
        h32_entry("k6", "sage_fwd_sm90 at head dim 32 (K6, int8 wgmma on 32-byte code rows under the 32-byte swizzle)",
                  "finetrainers_tpu_torch/csrc/sage_fwd_sm90.cu", "finetrainers_tpu/ops/sage_attention.py:36",
                  h32["k6"][0], h32["k6"][2]["dummy_self"]["k6"],
                  by_case={case: dict(zip(fields, r["k6"])) for case, r in h32["k6"][2].items()},
                  ptxas=h32_instances("sage_fwd_sm90", "sage_fwd_sm90_kernel"),
                  library_note="torch SDPA on the unquantized bf16 inputs: a yardstick only"),
        h32_entry("sage_prep", "sage_prep at head dim 32 (smooth-K and int8 quantization before K6)",
                  "finetrainers_tpu_torch/csrc/sage_fwd_sm90.cu", "finetrainers_tpu/ops/sage_attention.py:112",
                  h32["k6"][1], h32["k6"][2]["dummy_self"]["prep"],
                  by_case={case: dict(zip(fields, r["prep"])) for case, r in h32["k6"][2].items()},
                  max_abs_err_note="the largest difference of an int8 code from the plain pre-pass on the CPU",
                  plain_note="the plain pre-pass on the card"),
        branch_entry("k1", "causal", 205, (300,), "causal_dummy_h32", h=32),
        branch_entry("k1", "segment", 210, (), "varlen_dummy_packed_h32", h=32),
        branch_entry("k1", "mask", 217, (304,), "flex_dummy_sparse_h32", h=32),
        branch_entry("k2", "causal", 977, (1012,), "causal_dummy_h32", h=32),
        branch_entry("k2", "segment", 982, (), "varlen_dummy_packed_h32", h=32),
        branch_entry("k2", "mask", 985, (1016,), "flex_dummy_sparse_h32", h=32),
        branch_entry("k3", "causal", 1284, (1306,), "causal_dummy_h32", h=32),
        branch_entry("k3", "segment", 1289, (), "varlen_dummy_packed_h32", h=32),
        branch_entry("k3", "mask", 1292, (1310,), "flex_dummy_sparse_h32", h=32),
        variant_branch_entry("k7c", "causal", "causal_dummy_h32", 205, (229, 266, 300),
                             "flash_fwd_two_level_causal_sm90_kernel", h=32),
        variant_branch_entry("k7c", "segment", "varlen_dummy_packed_h32", 210, (229, 266),
                             "flash_fwd_two_level_segment_sm90_kernel", h=32),
        variant_branch_entry("k7c", "mask", "flex_dummy_sparse_h32", 217, (229, 266, 304),
                             "flash_fwd_two_level_mask_sm90_kernel", h=32),
        variant_branch_entry("k7a", "segment", "varlen_dummy_packed_h32", 438, (),
                             "flash_fwd_twopass_segment_sm90_kernel", h=32),
        variant_branch_entry("k7b", "segment", "varlen_dummy_packed_h32", 629, (), "flash_fwd_skew_segment_sm90_kernel",
                             h=32),
        variant_branch_entry("k5", "causal", "causal_dummy_h32", 1137, (1169,), "bwd_fused_sm90_kernel", h=32),
        variant_branch_entry("k5", "segment", "varlen_dummy_packed_h32", 1142, (), "bwd_fused_sm90_kernel", h=32),
        variant_branch_entry("k5", "mask", "flex_dummy_sparse_h32", 1145, (1173,), "bwd_fused_sm90_kernel", h=32),
        entry("flash_fwd_mask_sm90 (K1's dense-mask branch, wgmma + TMA, over each q tile's live key tiles)",
              "finetrainers_tpu_torch/csrc/flash_fwd_branches_sm90.cu", "finetrainers_tpu/ops/flash_attention.py:217",
              checkpoint_launches["k1_mask"], k1_mask_err,
              tuple(k1_mask["glm_causal_gqa"][f] for f in fields), shape=[1, 32, 1024, 1024, 128],
              launches_by_path={"cogview4_checkpoint_serve": checkpoint_launches["k1_mask"],
                                **{f"text_towers_{kind}": n for kind, n in tower_launches.items()},
                                "hunyuan_checkpoint_run_precompute":
                                    hy_ckpt["hunyuan_checkpoint_precompute"]["k1_mask"],
                                "flux_checkpoint_run_precompute": flux_ckpt["flux_checkpoint_precompute"]["k1_mask"]},
              by_case={case: {f: r[f] for f in fields} for case, r in k1_mask.items()},
              long_causal_unmasked_k1_ms=k1_mask["long_causal"]["unmasked_k1_ms"],
              kernel_source="finetrainers_tpu_torch/csrc/flash_fwd_sm90.cu",
              also_replaces=["finetrainers_tpu/ops/flash_attention.py:304"],
              ptxas=ptxas("flash_fwd_branches_sm90", "flash_fwd_mask_sm90_kernel"),
              ms_note="the mask's tile lists built once and cached, as a tower's layers share them",
              library_note="torch SDPA forward given the same boolean mask (the kv heads repeated)"),
        branch_entry("k1", "causal", 205, (300,), "causal_llama"),
        branch_entry("k1", "segment", 210, (), "varlen_wan_packed"),
        branch_entry("k2", "causal", 977, (1012,), "causal_llama"),
        branch_entry("k2", "segment", 982, (), "varlen_wan_packed"),
        branch_entry("k2", "mask", 985, (1016,), "flex_cogview4_padded_slots"),
        branch_entry("k3", "causal", 1284, (1306,), "causal_llama"),
        branch_entry("k3", "segment", 1289, (), "varlen_wan_packed"),
        branch_entry("k3", "mask", 1292, (1310,), "flex_cogview4_padded_slots"),
        variant_branch_entry("k7c", "causal", "causal_llama", 205, (229, 266, 300), "flash_fwd_two_level_causal_sm90_kernel"),
        variant_branch_entry("k7c", "segment", "varlen_wan_packed", 210, (229, 266),
                             "flash_fwd_two_level_segment_sm90_kernel"),
        variant_branch_entry("k7c", "mask", "flex_cogview4_padded_slots", 217, (229, 266, 304),
                             "flash_fwd_two_level_mask_sm90_kernel",
                             {"cogview4_checkpoint_serve_flex_two_level":
                              checkpoint_runner.get("flex_two_level_branch_launches", {}).get("k7c_mask", 0)}),
        variant_branch_entry("k7a", "segment", "varlen_wan_packed", 438, (), "flash_fwd_twopass_segment_sm90_kernel"),
        variant_branch_entry("k7b", "segment", "varlen_wan_packed", 629, (), "flash_fwd_skew_segment_sm90_kernel"),
        variant_branch_entry("k5", "causal", "causal_llama", 1137, (1169,), "bwd_fused_sm90_kernel"),
        variant_branch_entry("k5", "segment", "varlen_wan_packed", 1142, (), "bwd_fused_sm90_kernel"),
        variant_branch_entry("k5", "mask", "flex_cogview4_padded_slots", 1145, (1173,), "bwd_fused_sm90_kernel"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
