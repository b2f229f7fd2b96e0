"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA source of the port (gandtr_tpu_torch/csrc/*.cu, one
   nvcc each, all at once) into the ignored gandtr_tpu_torch/_build/,
   prints ptxas's register and spill report, and counts HGMMA (wgmma) and
   UTMALDG (TMA load) instructions in the conv kernels' SASS
   (`cuobjdump -sass`, where the toolkit has it): no HGMMA fails.
3. K1 (static CLAHE) against its plain PyTorch version on the card:
   bit-equal on a batch of 8 at 768x1024, a 29x35, a 362x500, a 3x5 and a
   32x37 image, at grids 8 and 4, two launches bit-equal, one kernel on the
   stream a call; kernel and plain medians by CUDA events.
   K2 (VGG16's 64/128-channel 3x3 conv) against its plain version at the
   fine-tune's (7, 364, 364, 64) and (7, 182, 182, 128) and at (2, 30,
   26, 64) and (2, 15, 13, 128), bf16 and float32 out, with and without
   ReLU: within 2e-2 and 2e-5, bit-equal on repeat; its autograd backward
   against autograd of the plain conv under the kernel's ReLU mask; K2,
   plain, library (cuDNN bf16 conv + bias + ReLU) medians and the bound.
   K4 (masked CLAHE, LUT build + interpolation) against its plain version
   bit for bit on a (7, 364, 364) bucket of the fine-tune's rectangles and
   a (4, 61, 75) one with 3x5 and 32x37 rectangles, grids 8 and 4, clips
   1.0 and 4.0, one kernel on the stream a call; kernel and plain medians.
   K1 and K4 are one kernel (csrc/clahe.cu) in static and masked mode.
4. K3 (the fused ResNet block) against its plain version and the float32
   block, at the served block shape (8, 192, 256, 256) and at (2, 17, 23,
   64): within max 0.06 and mean 0.01, and two launches bit-equal; K3,
   plain and library (cuDNN bf16 convs + torch instance norm) medians, and
   the kernels one block call runs on the stream (torch.profiler).
5. One server (`serve_http` on 127.0.0.1) holds both models of the port:
   the GeM-VGG16 hub model (seeded random weights, full width, multiscale,
   a seeded Lw) and the cyclegan hub generator (seeded random weights, 9
   blocks, bf16 compute). Each path is driven with every launch count set
   to 0 just before it and read just after, with rounds of 8 concurrent
   npy `:predict` requests of 768x1024 uint8 images:
   - descriptors: finite, unit norm, equal to the direct `Servable` call,
     and (one image) within 1e-4 of the port on the CPU; K1 launched;
   - generator: PNGs that decode to uint8 (768, 1024, 3) and are byte-equal
     to the direct call's; K3 launched 9 times per batch formed.
6. Generator parity on the card: K3 swapped for its plain version in the
   bf16 generator, and the float32 generator (no K3) against the port on
   the CPU on one 256x256 image. With kaiming_p2p weights: within max 0.06
   and mean 0.01, and within 1e-4. With the served seeded normal_p2p
   weights, a chaotic net, within mean 0.01; the rest is printed beside
   the net's own response to a one-level input change.
7. The GeM fine-tune tuple step of finetune.yml (`FINETUNE`: the
   published network and learning sections, seeded weights, the embed in
   bf16) through `build_finetune_experiment` on `cuda`: T=5 tuples of 7
   uint8 images in a 364 bucket, the anchors of tuples 0, 2 and 4 through
   the frozen 9-block batch-norm generator; 2 warm-up steps, then 5 timed
   steps with every launch count set to 0 just before them: finite losses,
   every embed parameter moved, the generator untouched, float32 master
   parameters, K2 launched 10 and K4 5 times per step. Then one step's
   breakdown by CUDA events, and parity: the bf16 step with K2 and K4
   swapped for their plain versions (loss within 1%, descriptors within
   5e-3, the updated conv weights within 1e-4 of their size), and one
   float32 tuple on the card against the port on the CPU (within 1e-4).
8. The retrieval eval of parameters/eval.yml (`EVAL`: its network and
   data sections as shipped, GeM-VGG16 full width with seeded weights, a
   seeded 512x512 Lw pickle) through the port's validate stage on `cuda`,
   on a seeded synthetic roxford5k-style set written to a temp dir (48
   database JPEGs and 6 queries with bbx crops, photo sizes from 800x600
   to 1280x960, a gnd with easy / hard / junk lists). Twice: with
   `shape_bucket: 64` (masked chain, K4) and `null` (exact shapes, K1),
   each once to warm up and once with every launch count set to 0 just
   before it: descriptors finite and unit norm, bucketed within 1e-4 of
   exact, equal APs for the queries whose ranks agree, K4 (bucketed) or K1
   (exact) launched once per extracted batch; the stage's set-up timed
   alone. K4 and K1 on the very inputs the counted runs gave them (each
   distinct bucket and rectangles, or exact shape, once): bit-equal to
   the plain version, one kernel a call, timed against the bound. The
   card's busy share over the dataset's evaluation (set-up left out;
   torch.profiler) and the host's time in the extractor's calls there.
   Then the ranking on the card against numpy's float64 argsort, two
   database images against the port on the CPU (within 1e-4), and the
   host / device split per image.
9. The fine-tune loop of finetune.yml (`finetune_loop_config`: its
   network, learning, data and output sections, seeded weights, the embed
   in bf16; cut to 2 epochs, query_size 20, qpool_size 40, pool_size 150,
   checkpoint_every 1, store_every 2) through `build_finetune_experiment`
   and `training.run` on `cuda`, on a seeded synthetic tuple set in a temp
   dir (180 JPEGs in 60 clusters of 3, longest side 362, the reference's
   pkl form), every launch count set to 0 just before the run: finite
   losses, every embed parameter moved, the generator untouched, every
   mined negative outside its query's cluster and the others' clusters,
   K4 once and K2 twice for each mining extraction batch and each tuple.
   A fresh experiment on a copy of the directory as it was after epoch 1
   resumes at epoch 2 with the parameters and Adam moments bit-equal and
   trains it to finite losses; `embed_best.ckpt` loads strict into a fresh
   GeM-VGG16 whose descriptors equal the trained net's; the gate-
   partitioned extraction of 16 images within 5e-3 of one mixed batch.
   Printed: each epoch's mining, steps, checkpoint and events seconds, ms
   a step in the loop against the bare step of 7, the card's busy share
   over epoch 2's steps (torch.profiler), the loader threads' host ms a
   step, the extraction rate of each partition, the host seconds of one
   published epoch's mining on seeded random descriptors, and a labelled
   projection of a published epoch.
10. The ResNet-101 chain of finetune_r101 and eval_r101 (`run_r101`), at
   full width and depth (2048-d, a 2048x2048 Lw), seeded weights, each
   part with every launch count set to 0 just before it: (a) the hub's
   gem_resnet101_cyclegan served (8 concurrent 768x1024 npy requests, K1
   once a batch): finite unit-norm descriptors equal to the direct call,
   2 images within 1e-4 of the CPU port; (b) step 1, the loop of (9) with
   a ResNet-101 embed and margin 0.85 (`finetune_r101_config`): finite
   losses, every embed parameter moved (BatchNorm affine included), every
   BatchNorm statistic bit-equal, K4 once a tuple and an extraction batch
   and no K2, then the bare step on the step phase's batch; (c) step 2,
   infer_and_learn_whitening by whitening.yml from (b)'s
   epochs/embed_best.ckpt on the tuple set's photos in the reference's
   cid tree: lw-retrieval.pkl with a 2048x2048 P, K4 once a batch, the
   seconds of Lw learning, an existing pickle skipped; (d) step 4,
   validate by eval.yml from the same file and pickle, bucketed and exact
   as in (8); (e) K1 and K4 held bit for bit against their plain versions
   on the very inputs (a) to (d) gave them, summarised a kernel.
11. HED^N-GAN training of parameters/train_hedngan.yml (`run_gan_train`:
   GAN_TRAIN, the file as shipped, at full width: the batch-norm 9-block
   generator at ngf 64, the 3-layer discriminator at ndf 64, the HED
   student and its frozen teacher at width 1.0 with seeded weights; cut by
   GAN_CUTS to 40 pairs (4 steps of 10 an epoch), 2 epochs with the lr
   decay in the second, checkpoint_every 1, store_every 2, the visual
   validation every epoch) through `build_gan_experiment` and
   `training.run` on `cuda`, on a seeded domain set in a temp dir (30
   JPEGs a domain, longest side 362; 4 validation photos), every launch
   count set to 0 just before the run (the path reaches no kernel of the
   port: cuDNN float32, so every count reads 0): the student equal to its
   teacher bit for bit before the first step and E_real exactly 0 at step
   1; after 2 epochs every parameter of G, D and the student moved, the
   teacher bit-equal, G's and D's BatchNorm statistics moved; no metric
   NaN; the epoch files, blobs and the HTML report written; a copy of the
   directory as it was after epoch 1 resumed to epoch 2 bit for bit
   (networks, statistics, the three optimizers' moments);
   generator_X_last.ckpt strict into hub.hedngan, serving one 768x1024
   photo; one step at batch 2 and 128x128 against the port on the CPU
   (losses within 1e-3 relative, fake_Y within 1e-4; D's, the student's
   and the generator's two terms' gradients each no further from a
   float64 CPU reference than twice the CPU float32's distance; the
   updated generator within 2 lr, a sanity check). Printed: ms a step
   bare and in the loop, images/s, the card's busy share over epoch 2's
   steps (torch.profiler), CUDA-event spans of a step's parts, peak
   memory and the epoch split.
12. The scenario CLI (`run_scenario`), in a temp dir set as $GANDTR_ROOT
   whose data/ tree is what the download checks expect (seeded photos:
   SfM-120k's cid tree with the 180-photo tuple set, its database and
   whitening pickles, day / night lists of 30 photos, the 4 VAL_IMS
   photos; roxford5k, rparis6k and 247tokyo1k of 24 + 3 photos each):
   (a) train/hedngan.yml's `all` target through
   `gandtr_tpu_torch.scenarios.run.main` in this process at full width,
   cut by the CLI's own key=value overrides (`all_target_overrides`: the
   GAN as GAN_CUTS, the fine-tune as finetune_loop_config with the embed
   in bf16 from a seeded local file, whitening's pickle local), every
   launch count set to 0 just before it: generator_X_best.ckpt,
   embed_best.ckpt (the augment loaded from the GAN's file),
   lw-retrieval.pkl (512x512), finite E/M/H mAPs of the three sets and
   the printed scores; K4 and K2 launched, K1 and K3 not, and every call
   of K4 and K2 recorded and held against its plain version (K4 bit for
   bit, K2 within 2e-2); each step's seconds, the GAN's ms a step and the
   card's busy share over its epoch 2; (b) the `output` target in a process of its own with 8 photo
   names on stdin, twice: one PNG a name, within one level of the trained
   generator applied directly, and the second (append) run writes
   nothing; (c) train/cyclegan.yml's `train` target at full width (ngf
   64, 256x256 crops, batch 1), 2 epochs of 4 steps: no launch, epoch 2
   resumed from a copy bit for bit (networks, moments, pools), one step
   at 128x128 on the shipped normal_p2p weights, card vs CPU: losses
   1e-3 relative, the fakes, reconstructions and four gradients within
   twice the CPU float32's distance from a float64 CPU step (with
   kaiming_p2p weights also the images within 1e-4); the trained
   generator_X served through hub.cyclegan in bf16, K3 launched 9 times
   and held on each block call's inputs against its plain version (mean
   0.01; each element 0.06 or one bf16 step of the output).
13. The paper's other GAN families through the scenario CLI
   (`run_gan_families`), in a temp dir set as $GANDTR_ROOT holding the
   SfM-120k layout the download check expects (make_domain_set's 30 + 30
   photos and their lists, placeholder pickles, the 4 VAL_IMS photos) and
   seeded local HED and RCF files in place of the published ones: the
   `train` targets of train/hedgan.yml, rcfgan.yml, rcfngan.yml (HED-GAN
   and RCF-GAN: the detector frozen, HED^N-GAN's step with RCF teacher
   and student) and cut.yml, as shipped at full width, cut by FAMILY_CUTS
   with the CLI's own overrides (batch 10 of 256² crops and 40 pairs, 2
   epochs, RCF-GAN 1; CUT batch 1, 16 pairs, dispatch_chunk 8, 2 epochs;
   the lr decay in the last epoch, checkpoint_every 1, store_every 2, the
   visual validation every epoch), each with every launch count set to 0
   just before it (no kernel: float32 cuDNN): finite losses, every
   optimised parameter moved (but one whose lr is below half an ulp of
   each element), the networks without an optimizer unchanged, the epoch
   files, samples and visual validation written; RCF^N-GAN and CUT
   resumed from a copy after epoch 1, epoch 2 bit for bit (networks,
   moments, CUT's patch generator); one step of each family at 64x64,
   card vs CPU: losses 1e-3 relative, the debug images and every
   optimised network's gradient within twice the CPU float32's distance
   from a float64 CPU step (D's and the student's lr 0 there, CUT on
   fixed patch positions); RCF's forward and forward + backward at batch
   10, 256², its gradients bit-equal on repeat; the CUT-trained
   generator_X served through hub.cyclegan in bf16, K3 launched 9 times
   and held on each block call against its plain version. Printed per
   family: seconds, the loop's ms a step and the card's busy share over
   the last epoch's steps, peak memory.
14. Retrieval search and deployment (`run_search`), in a temp dir set as
   $GANDTR_ROOT, every launch count set to 0 just before each part and
   read just after: 32 seeded 768x1024 JPEGs indexed by the build_index
   stage and the GeM-VGG16 (full width, 3 scales, a seeded Lw, seeded
   weights in a local checkpoint) exported by the export stage at
   768x1024 with buckets (1, 4, 8), both through the scenario engine's
   run_target with eval.yml's network form; the cyclegan generator's bf16
   artifact. Checks: the loaded descriptor artifact within 1e-5 of the
   in-memory Servable (and 1e-4 of build_index's rows), the generator's
   uint8 byte-equal. The database: the photos' rows and 1,001,001 seeded
   unit 512-d rows made on the card (the R1M distractor count; 2.05 GB of
   float32 rows uploaded), with 8 photo rows planted again among them:
   the exact index's top-10 of 16 queries equal to a float64 host ranking,
   each planted copy right after its photo's row (the lower index first).
   The PQ index (m 16, ksub 256, k-means on 25,600 rows, rerank 100):
   65,536 rows' codes and scan equal to the CPU's on the card's codebooks
   (codes at float64 near-ties and top-k at near-ties excepted and
   counted). One serve_http: 8 concurrent `:search?k=10` requests (npy
   photos) a round against the exact index, then the PQ index, each
   answer equal to index.query on the direct call's descriptor (the photo
   first, its planted copy second); 8 concurrent `:predict` requests to
   the generator artifact, PNGs byte-equal to its direct call. K1
   launched by the descriptor artifact (at least once a batch) and held
   bit for bit against its plain version on the recorded inputs; K3 9
   times a batch by the generator artifact, each block call of the last
   batch held against its plain version (phase 13's rule). Printed: the
   stages' seconds, artifact sizes, upload, k-means and encoding rows/s,
   the matmul, top-k and PQ scan ms at Nq 1 and 16 (CUDA events) beside
   one torch.topk, each query's host ms, and :search requests/s.
15. The training options (`run_training_options`), at full width:
   (a) HED^N-GAN of train_hedngan.yml (GAN_TRAIN, batch 10 of 256²,
   seeded weights; the path reaches no kernel): `concat_student` from a
   state after 2 separate steps, the E step's ms both ways (CUDA events)
   and, at batch 2 and 128², the student's E-step gradient with the knob
   on the card within twice the CPU float32's distance from the float64
   CPU gradient, both routed by float64's ReLU and max-pool decisions
   (the unrouted distances and the gates set the other way printed);
   `cache_teacher_targets` fed 4 loader batches 3 times:
   4 misses, 8 hits, bit-equal to the plain build's run, ms of a hit and
   a miss; `device_scalecrop` against the host chain through the loader
   and `Training.run` (one epoch of 8 steps): equal crop boxes, the
   staged batch within 1e-5, host ms, bytes, ms a step and busy share
   each way; SGD (momentum 0.9) on the detector in a rotation of 2
   steps a member for 6 steps: only the active member moves, and a
   resume after step 3 repeats steps 4 to 6 bit for bit; a `path:`
   generator from the device run's generator_X_last.ckpt, equal to the
   file before its step. (b) The fine-tune loop of (9) with a seeded val
   split of 180 JPEGs (query_size 20, pool_size 150), the validation every
   epoch, TensorBoard, and a ScoreValidation over (8)'s seeded set at
   exact shapes; 2 epochs with every launch count set to 0 just before:
   finite validation losses, val tuples mined with each epoch's weights,
   `_best` at the lower loss, the JAX score keys, the TensorBoard file's
   CRCs and epoch scalars equal to the events; K4 and K2 in the loss
   validation and K1 in the score eval, their recorded calls (4 an input
   shape) held against the plain versions; one validation's tuples,
   mined once, scored with K2 and with the plain versions: within 1%; a
   triplet step (margin 0.1) finite and within 1% of
   its plain-kernel step. Printed: the numbers of each part and the
   phase's seconds.
16. Every network of the model registry that no phase above runs
   (`run_architectures`), at full width, in a temp dir set as
   $GANDTR_ROOT (make_family_data's SfM-120k layout, seeded HED and RCF),
   each part with every launch count set to 0 just before it and read
   just after: (b) cut.yml's `train` target through the CLI with upstream
   CUT's blur-pool sampling on G (no_antialias and no_antialias_up false)
   and D, cut as in (13) but to 8 pairs an epoch: phase 13's checks,
   epoch 2 resumed bit for bit, one step at 64² against float64;
   cyclegan.yml's `train` target with pix2pix's unet_256
   (`official_unet_generator`, num_downs 8, ngf 64, batch norm) for both
   generators, 2 epochs of 4 steps at 256², the visual validation off
   (unet_256 takes 256² only): no launch, epoch 2 resumed bit for bit,
   one step at 256² against float64 (phase 12's rule); the loops' busy
   shares are the union of the card's event intervals (`_device_busy_us`,
   as every GAN loop's since); (a) the blur-pool generator_X of (b) through
   hub.cyclegan in bf16, served by serve_http to rounds of 8 concurrent
   768x1024 requests: K3 9 times a batch, PNGs byte-equal to the direct
   call, within max 0.06 / mean 0.01 of the plain-K3 generator, float32
   within 1e-4 of the CPU port at 256²; an official_resnet_encoder ->
   official_resnet_decoder chain (6 + 6 blocks, bf16, kaiming_p2p) on
   the 8 photos: K3 12 times, each block call held against its plain
   version by phase 13's rule, the output within mean 0.01 of the plain
   chain's, its largest distance from the float32 chain on the same
   weights within CHAIN_FACTOR (2) of the plain chain's;
   (c) eval.yml's validate stage at exact shapes (K1) on (8)'s seeded
   set for regional GeM, R-MAC, cirnet_attention, cirnet_inchan and
   {type: GeometricMedianWeiszfeld, iterations: 3}: K1 once a photo,
   unit-norm descriptors, mAPs and images/s, one photo within 1e-4 of
   the CPU port; (d) finetune.yml's tuple step (T=5, bf16) with a
   cirnet_inchan embed: K2 10 and K4 5 times a step, the edge filter's p
   and tau moved, the loss within 1% and descriptors within 5e-3 of the
   plain-kernel step. Prints the phase's seconds.
17. The data side (`run_data_side`), at full width with seeded weights
   and seeded photos in a temp dir set as $GANDTR_ROOT, each part with
   every launch count set to 0 just before it and read just after:
   (a) eval.yml's validate stage with `pil2np | apply_clahe:1.0:8:<space>
   | totensor | normalize` for luv, lsh and hsv on (8)'s seeded set,
   bucketed (K4) and exact (K1): (8)'s checks (one launch a photo,
   bucketed within 1e-4 of exact), 2 photos within 1e-4 of the CPU port,
   every K1 and K4 call of the counted runs bit-equal to its plain
   version, images/s a space and mode; (b) finetune.yml's tuple step
   (T=5, S=7, 364², bf16) with `clahepost:...:1.0:8:luv`: K2 10 and K4 5
   a step over 4 steps, each K4 call bit-equal to its plain version, the
   4 steps with plain K2 and K4 from the same weights within 1% (loss)
   and 5e-3 (descriptors); (c) train_hedngan.yml through the train stage
   on PregeneratedImageTuple (idx 0_1, 40 rows of 3 seeded 448x512
   JPEGs), `centerscalecrop:256_256:0.6`, batch 10 unshuffled, 2 epochs,
   with and without `cache_teacher_targets`: epoch 1 all misses, epoch 2
   all hits, the runs bit-equal, no launch; hit and miss ms, the busy
   share; (d) train_cyclegan.yml through the train stage on
   RandomImageTuple (idx 0_any, 4 rows) with `mirror | random_crop:256 | gaussian_noise:0.01 |
   tospace:luv`, 2 epochs; then the infer stage's image output of its
   generator_X with `tospace:luv` (the sink undoes luv) and
   `reflectpad_divisible:4` on photos with no side a multiple of 4: PNGs
   of the inputs' shapes; every photo's outputs the sink took within
   twice the CPU float32's distance from float64 (12's rule); the PNGs
   off the CPU port's on at most 0.1% of values, and by more than a level
   only where the undo is that ill-conditioned (the levels the sink
   writes about the float64 output, within the card's and the CPU's
   largest output difference, span as much); `device_postprocess: true`
   (plain RGB), for the trained generator and for seeded He-normal
   weights whose outputs do not sit on levels, within a level of the
   host sink, and only at float32 / float64 truncation ties (the float64
   value within 1e-4 of a level); no launch in the training or the
   output. Prints each part and the phase's seconds.
18. The model side (`run_local_multihead`), at full width with seeded
   weights and seeded photos, each part with every launch count set to 0
   just before it and read just after: (a) GlobalLocalModule on the hub's
   GeM-VGG16 (float32) through its served preprocessing (LAB CLAHE, K1
   once a batch, each call bit-equal to its plain version) over 40
   768x1024 photos, 5 scales (about 5.9k local features a photo, L2-
   normalized), forward_global within 1e-5 of the net's single-scale
   descriptor, images/s; (b) ClusteringCodebook("64k", 10 iterations)
   over the first 32 photos' features (about 188k points): repeated bit
   for bit, its pickle (LoadedCodebook's layout) loaded back bit-equal,
   the last iteration's assignment of 4,096 points equal to float64's
   except where float64's relative gap is under 1e-4, seconds an
   iteration; (c) the hard path (res, top-1, uniform, l2norm, maxass) on
   the next 7 photos (a tuple) with the 64k codebook, with and without
   top_centroids 8k and 2k (2k drops features: the query and positive
   choose more centroids), and with a seeded 512k codebook and
   top_centroids 8k: each twice bit-equal, descriptors and weights within 1e-5 of
   float64 on the rows whose assignments agree, the 512k run's peak
   beyond its inputs under 2 GiB, ms a tuple; (d) a 1k codebook with
   softmax-20 (res features) and BatchClustering (kmeans, 256 clusters,
   10 iterations; iden features: a residual about a cluster's own mean
   cancels) on one photo's scale-1 features, by (c)'s float64 rule; (e) one
   backward through (c)'s 64k path: twice bit-equal, within 1e-5 of the
   float64 backward (relative to its largest) where assignments agree;
   (f) a MultiheadModule in bf16 (official_resnet_encoder, 6 blocks,
   instance norm -> two official_resnet_decoder heads, kaiming_p2p) on 8
   photos: K3 18 times, each block call held by phase 13's rule,
   default_output equal to the all-outputs dict, each output's largest
   distance from the float32 net within CHAIN_FACTOR of the plain-K3
   net's, each head's within mean 0.01 of the plain-K3 net's; one float32 Adam step with MH_GROUPS on 64x64 crops: each
   group's lr and weight decay as configured, each subnet moved by at
   most its lr, the weights within 1e-5 of the same step on the CPU port.
   Prints each part and the phase's seconds.
19. Data parallelism, the sharded artifacts and the native decoder
   (`run_parallel`, parallel/mesh.py), each part with every launch count
   set to 0 just before it and read just after: (a) two ranks on the one
   card over gloo (torch.multiprocessing, CUDA tensors; NCCL refuses two
   ranks on one device): finetune.yml's bf16 step at T=4 of S=7 in the
   364 bucket (2 tuples a rank, K2 2 and K4 1 a tuple on each rank)
   against one process's step on the same global batch by §2's step rule
   (loss 1%, tuple 0's descriptors 5e-3 after the step, weights 1e-4 of
   their largest), and one HED^N-GAN step of train_hedngan.yml at full
   width, batch 10 of 256² (5 a rank, BatchNorm over the global batch)
   against one process's: the gradients each optimizer steps with (after
   the all-reduce) bit-equal on both ranks and within PAR_GAN_GRAD_REL
   relative norm (G 0.1, D and the student 1e-3), a control (the ranks
   with the all-reduce off) beyond it on every optimizer, losses 1e-3
   relative, weights within 2 lr, statistics 1e-5 (G) and 1e-3 (D);
   (b) one rank over NCCL: the fine-tune step bit-equal
   to the run without a group; (c) eval.yml's extraction of 8 of (8)'s
   seeded photos over the two ranks, exact (K1) and bucketed (K4), each
   rank 4, bit-equal to one process's; (d) the served generator (K3) and
   descriptor (K1) artifacts exported sharded 2 ways at 4 rows a share and
   loaded on [cuda:0, cuda:0] (a stream a share) against the unsharded
   artifacts on 8 photos: 1 uint8 level, 1e-4; K3 18 and K1 2 a batch;
   (e) which decoder runs (the build error where the native one did not
   build); where it built, 24 seeded JPEGs and PNGs decoded byte-equal to
   PIL, and its 6-thread pool's images/s beside PIL's on 6 threads. Times
   are the card's own (this card, one process or two ranks sharing it);
   no multi-card speed is claimed.
20. Stage breakdowns of one batch of each served path, the `{"kernels":
   [...]}` line (each kernel with its launches by path, K1 and K4 with
   their times at the eval's geometry and the r101 inputs), the card's
   line again, and last `{"ok": true, "device": {...}}`.

Times are CUDA events around a window of back-to-back calls (`cuda_ms`).
Exits nonzero, printing no result, without CUDA or without the package.
"""
import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HW = (768, 1024)          # a 1024x768 (W x H) photo, the served shape
N_REQ = 8                 # concurrent requests per round
ROUNDS = 3                # timed rounds after one warm-up round
HBM_BYTES_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOP_S = 989e12      # H100 SXM dense bf16 tensor cores
K3_SHAPES = [(N_REQ, HW[0] // 4, HW[1] // 4, 256), (2, 17, 23, 64)]
K3_MAX, K3_MEAN = 0.06, 0.01   # tests/test_resblock_pallas.py:47-49
# the GeM fine-tune tuple step: T tuples of S images in a 364 bucket (the
# published image_size 362, rounded for the generator), with the
# rectangles imresize(., 362) leaves
BUCKET = 364
K4_RECTS = [(362, 241), (272, 362), (362, 362), (362, 203), (300, 362),
            (41, 57), (29, 35)]
K2_SHAPES = [(7, BUCKET, BUCKET, 64), (7, BUCKET // 2, BUCKET // 2, 128),
             (2, 30, 26, 64), (2, 15, 13, 128)]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2, runs=3):
    """Milliseconds of one `fn()` on the card: CUDA events around `reps`
    calls in a row (so the host's launch work overlaps the card's), the
    median over `runs` such windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def build_all():
    from gandtr_tpu_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = _build.build(names)
    secs = time.perf_counter() - t0
    for name, so in libs.items():
        log = so.with_name(so.name + ".log")
        ptxas = log.read_text() if log.exists() else "(already built)"
        print("built %s -> %s" % (name, so.relative_to(ROOT)))
        for line in ptxas.splitlines():
            if ("registers" in line or "spill" in line or "wgmma" in line
                    or "setmaxnreg" in line or "error" in line.lower()):
                print("  " + line.strip())
    print("build: %d sources in %.1f s" % (len(names), secs))
    return libs


def sass_report(libs, names=("vggconv", "resblock")):
    """Whether each conv kernel's SASS has HGMMA (wgmma) and UTMALDG (TMA
    loads), from `cuobjdump -sass` of its built library; None where the
    toolkit has no cuobjdump."""
    from gandtr_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {}
    for name in names:
        if not os.path.exists(tool):
            out[name] = None
            continue
        sass = subprocess.run([tool, "-sass", str(libs[name])],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            raise RuntimeError("cuobjdump failed on %s: %s"
                               % (name, sass.stderr[-2000:]))
        out[name] = {op: sass.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
    print("SASS of the conv kernels (instruction counts): %s"
          % json.dumps(out))
    for name, counts in out.items():
        if counts is not None and not counts["HGMMA"]:
            raise AssertionError("%s has no HGMMA in its SASS" % name)
    return out


def _kernel_modules():
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    return {"K1": kclahe, "K2": kvgg, "K3": kres, "K4": kmasked}


def reset_launches():
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def launches():
    return {k: mod.LAUNCHES for k, mod in _kernel_modules().items()}


def _clahe_bound(shape, valid_px, n_sizes=0):
    """(bound seconds, "bytes" or "operations") of a CLAHE call on a uint8
    (N, H, W) buffer of which `valid_px` pixels are inside the images'
    rectangles: those read once, the whole buffer written once, the (N, 2)
    int32 sizes read once; the interpolation's 17 f32 operations a valid
    pixel (two coordinate chains of a mul and two subs, the two `1 - a`,
    6 mul + 3 add in the lerp; the per-tile LUT work is negligible)."""
    nbytes = valid_px + int(np.prod(shape)) + 4 * n_sizes
    flops = 17 * valid_px
    by_bytes = nbytes / HBM_BYTES_S >= flops / F32_FLOP_S
    return (max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S),
            "bytes" if by_bytes else "operations")


def _clahe_case(name, kernel, plain, shape, valid_px, n_sizes, per_call,
                verbose=True):
    """One CLAHE call on an eval input: bit-equal to its plain version, one
    kernel on the stream (`per_call`, as counted); kernel and plain medians
    and the bound, printed when `verbose`."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    d = int((got.int() - want.int()).abs().max())
    if d or not torch.equal(got, kernel()) or per_call != 1:
        raise AssertionError("%s %s: max |kernel - plain| %d, %s kernels "
                             "a call" % (name, tuple(shape), d, per_call))
    ms = cuda_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=3)
    bound_s, bound_by = _clahe_bound(shape, valid_px, n_sizes)
    if verbose:
        print("%s %s: bit-equal to plain, 1 kernel a call; kernel %.4f ms, "
              "plain %.4f ms, bound %.5f ms (%s)"
              % (name, tuple(shape), ms, plain_ms, bound_s * 1e3, bound_by))
    return {"shape": list(shape), "max_abs_err": d, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by}


def check_k1(dev):
    """K1 against its plain version, bit for bit: a batch of 8 at 768x1024,
    a 29x35 image, smooth content, a 3x5 image (cv2's pad larger than the
    image), and a 32x37 one (H divides the grid, W does not: an extra tile
    row); one kernel on the stream a call; returns the max |diff| and the
    timings at the main path's shape."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    rng = np.random.RandomState(0)
    cases = [rng.randint(0, 256, (N_REQ,) + HW, dtype=np.uint8),
             rng.randint(0, 256, (29, 35), dtype=np.uint8),
             # smooth content with a narrow range: many clipped bins
             (np.add.outer(np.arange(362), np.arange(500)) % 64
              + rng.randint(0, 8, (362, 500))).astype(np.uint8),
             rng.randint(0, 256, (3, 5), dtype=np.uint8),
             rng.randint(0, 256, (2, 32, 37), dtype=np.uint8)]
    worst = 0
    for img in cases:
        x = torch.from_numpy(img).to(dev)
        for grid, clip in [(8, 1.0), (4, 1.0), (8, 4.0)]:
            got = kclahe.clahe_u8_cuda(x, clip, grid)
            again = kclahe.clahe_u8_cuda(x, clip, grid)
            want = clahe_u8_plain(x, clip, grid)
            torch.cuda.synchronize()
            d = int((got.int() - want.int()).abs().max())
            worst = max(worst, d)
            print("K1 %-16s grid %d clip %.1f: max |kernel - plain| = %d, "
                  "repeat bit-equal %s" % (tuple(img.shape), grid, clip, d,
                                           torch.equal(got, again)))
            if d or not torch.equal(got, again):
                raise AssertionError("K1 differs from its plain version")
    x = torch.from_numpy(cases[0]).to(dev)
    per_call = _stream_launches(lambda: kclahe.clahe_u8_cuda(x, 1.0, 8))
    print("K1 kernels on the stream a call (torch.profiler): %s" % per_call)
    if per_call != 1:
        raise AssertionError("K1 ran %s kernels in one call" % per_call)
    ms = cuda_ms(lambda: kclahe.clahe_u8_cuda(x, 1.0, 8), reps=20)
    plain_ms = cuda_ms(lambda: clahe_u8_plain(x, 1.0, 8), reps=5)
    bound_s, bound_by = _clahe_bound(x.shape, x.numel())
    print("K1 at %s grid 8: kernel %.4f ms, plain %.4f ms, bound %.4f ms"
          % (tuple(x.shape), ms, plain_ms, bound_s * 1e3))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "stream_launches": per_call,
            "bound_by": bound_by}


def _block_f32(x, w1, b1, w2, b2, eps=1e-5):
    """The float32 block (tests/test_resblock_pallas.py:12-25), NHWC."""
    import torch.nn.functional as F

    def conv(h, w, b):
        hp = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        return (F.conv2d(hp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b)

    def inorm(h):
        m = h.mean(dim=(1, 2), keepdim=True)
        v = ((h - m) ** 2).mean(dim=(1, 2), keepdim=True)
        return (h - m) / torch.sqrt(v + eps)

    h = torch.relu(inorm(conv(x, w1, b1)))
    return x + inorm(conv(h, w2, b2))


def _block_library(x, w1, b1, w2, b2, eps=1e-5):
    """The same block of PyTorch library calls (cuDNN bf16 convs, torch's
    instance norm), channels-last: timed beside K3, used nowhere."""
    import torch.nn.functional as F

    def conv(h, w, b):
        hp = F.pad(h, (1, 1, 1, 1), mode="reflect")
        return F.conv2d(hp.contiguous(memory_format=torch.channels_last), w,
                        b)

    h = torch.relu(F.instance_norm(conv(x, w1, b1), eps=eps))
    return x + F.instance_norm(conv(h, w2, b2), eps=eps)


def _stream_launches(fn, tries=5):
    """Kernels the card ran for one `fn()`, by torch.profiler's CUDA events;
    a profile that records no kernel at all (the profiler drops one now and
    then) is taken again, up to `tries` times, then "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.lower().startswith(("memset", "memcpy"))]
        if names:
            return len(names)
    return "not measured"


def check_k3(dev):
    """K3 against its plain version and the float32 block; returns the
    errors and the timings at the served block shape."""
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.ops.resblock import (fused_resblock,
                                               fused_resblock_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for shape in K3_SHAPES:
        N, H, W, C = shape

        def randn(*s, scale):
            return (torch.randn(s, generator=g, device=dev) * scale).to(
                torch.bfloat16)

        # tests/test_resblock_pallas.py's _random_case scales, in bf16
        x = randn(N, H, W, C, scale=0.5)
        w1, w2 = randn(3, 3, C, C, scale=0.05), randn(3, 3, C, C, scale=0.05)
        b1, b2 = randn(C, scale=0.1), randn(C, scale=0.1)
        args = (x, w1, b1, w2, b2)
        got = fused_resblock(*args)
        again = fused_resblock(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K3 is not deterministic at %s" % (shape,))
        errs = {}
        for ref_name, ref in (
                ("plain", fused_resblock_plain(*args).float()),
                ("f32 block", _block_f32(*(a.float() for a in args)))):
            d = (got.float() - ref).abs()
            errs[ref_name] = (float(d.max()), float(d.mean()))
            del d
        print("K3 %s: max/mean |kernel - plain| = %.5f / %.6f, "
              "|kernel - f32 block| = %.5f / %.6f, repeat bit-equal"
              % ((shape,) + errs["plain"] + errs["f32 block"]))
        for name, (mx, mean) in errs.items():
            if not (mx < K3_MAX and mean < K3_MEAN):
                raise AssertionError("K3 vs %s at %s: max %g mean %g"
                                     % (name, shape, mx, mean))
        if shape != K3_SHAPES[0]:
            continue
        out["max_abs_err"] = errs["plain"][0]
        out["ms"] = cuda_ms(lambda: fused_resblock(*args), reps=10)
        # the wrapper alone, past the custom op (ops/library.py): the op's
        # dispatch cost is the difference
        wm1, wm2 = w1.view(9 * C, C), w2.view(9 * C, C)
        out["wrapper_ms"] = cuda_ms(
            lambda: kres.fused_resblock_cuda(x, wm1, b1, wm2, b2), reps=10)
        out["plain_ms"] = cuda_ms(lambda: fused_resblock_plain(*args),
                                  reps=3, warmup=1)
        cl = torch.channels_last
        xl = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW: channels-last
        lw1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        lw2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        out["library_ms"] = cuda_ms(
            lambda: _block_library(xl, lw1, b1, lw2, b2), reps=10)
        flops = 2 * 2 * N * H * W * 9 * C * C
        nbytes = 2 * (2 * N * H * W * C + 2 * 9 * C * C + 2 * C)
        out["bound_ms"] = 1e3 * max(flops / BF16_FLOP_S,
                                    nbytes / HBM_BYTES_S)
        out["bound_by"] = ("operations" if flops / BF16_FLOP_S
                           >= nbytes / HBM_BYTES_S else "bytes")
        out["tflop_s"] = flops / out["ms"] / 1e9
        out["stream_launches"] = _stream_launches(
            lambda: fused_resblock(*args))
        print("K3 at %s: kernel %.3f ms (%.1f TFLOP/s; the wrapper alone "
              "%.3f ms), plain %.3f ms, library %.3f ms, bound %.4f ms (%s)"
              % (shape, out["ms"], out["tflop_s"], out["wrapper_ms"],
                 out["plain_ms"], out["library_ms"], out["bound_ms"],
                 out["bound_by"]))
        print("K3 launches per block call on the stream (torch.profiler): "
              "%s" % out["stream_launches"])
        del xl, lw1, lw2
    del x, w1, w2, b1, b2, args, got, again
    torch.cuda.empty_cache()
    return out


def _within(got, want, tol):
    """max |got - want| - tol * (1 + |want|) <= 0, and the max |diff|."""
    d = (got.float() - want.float()).abs()
    excess = float((d - tol * (1 + want.float().abs())).max())
    return excess <= 0, float(d.max())


def check_k2(dev):
    """K2 against its plain version (float32 sums of the same bf16 products)
    at the fine-tune path's two shapes and two ragged ones, bf16 and float32
    out, with and without ReLU: within 2e-5 (float32 out) and 2e-2 (bf16
    out) of 1 + |plain| (tests/test_vggconv_pallas.py:38, :51), and two
    launches bit-equal. Then Conv3x3Same's backward against autograd of the
    plain conv under the kernel's own ReLU mask, and the timings at the
    path's shapes (bf16 out, ReLU, as VGG16 calls it)."""
    import torch.nn.functional as F
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.ops.vggconv import conv3x3_same_plain
    set_float32_policy()        # the plain conv in full float32
    g = torch.Generator(device=dev).manual_seed(5)
    out = {"shapes": {}, "max_abs_err": 0.0}
    for shape in K2_SHAPES:
        N, H, W, C = shape
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, C, C), generator=g, device=dev)
             / (3.0 * C ** 0.5)).to(torch.bfloat16)
        b = torch.randn((C,), generator=g, device=dev) * 0.1
        wmat = w.reshape(9 * C, C)
        for out_dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            for relu in (False, True):
                got = kvgg.conv3x3_same_cuda(x, wmat, b, relu, out_dtype)
                again = kvgg.conv3x3_same_cuda(x, wmat, b, relu, out_dtype)
                want = conv3x3_same_plain(x, w, b, relu, out_dtype)
                torch.cuda.synchronize()
                ok, err = _within(got, want, tol)
                print("K2 %-18s %-8s relu %d: max |kernel - plain| = %.3g, "
                      "repeat bit-equal %s"
                      % (shape, str(out_dtype).split(".")[1], relu, err,
                         torch.equal(got, again)))
                if not ok or not torch.equal(got, again):
                    raise AssertionError("K2 at %s %s relu %d: %g"
                                         % (shape, out_dtype, relu, err))
                if shape in K2_SHAPES[:2] and out_dtype == torch.bfloat16 \
                        and relu:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                del got, again, want
        if shape in (K2_SHAPES[1], K2_SHAPES[2]):
            _check_k2_backward(x, w, b, g)
        if shape not in K2_SHAPES[:2]:
            continue
        t = {"ms": cuda_ms(lambda: kvgg.conv3x3_same_cuda(
            x, wmat, b, True, torch.bfloat16), reps=20)}
        t["plain_ms"] = cuda_ms(lambda: conv3x3_same_plain(
            x, w, b, True, torch.bfloat16), reps=5)
        xl = x.permute(0, 3, 1, 2)     # NHWC memory seen as NCHW
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bl = b.to(torch.bfloat16)
        t["library_ms"] = cuda_ms(lambda: torch.relu(F.conv2d(
            xl, wl, bl, padding=1)), reps=20)
        flops = 2 * N * H * W * 9 * C * C
        nbytes = 2 * N * H * W * C * 2 + 9 * C * C * 2 + C * 4
        t["bound_ms"] = 1e3 * max(flops / BF16_FLOP_S, nbytes / HBM_BYTES_S)
        t["bound_by"] = ("operations" if flops / BF16_FLOP_S
                         >= nbytes / HBM_BYTES_S else "bytes")
        t["tflop_s"] = flops / t["ms"] / 1e9
        print("K2 at %s (bf16 out, ReLU): kernel %.4f ms (%.1f TFLOP/s), "
              "plain %.4f ms, library %.4f ms, bound %.4f ms (%s)"
              % (shape, t["ms"], t["tflop_s"], t["plain_ms"],
                 t["library_ms"], t["bound_ms"], t["bound_by"]))
        out["shapes"][str(shape)] = t
        del xl, wl
    # one tuple's K2 work: conv1_2 and conv2_2 each once
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        out[key] = sum(t[key] for t in out["shapes"].values())
    out["bound_by"] = "operations"
    torch.cuda.empty_cache()
    return out


def _check_k2_backward(x, w, b, g):
    """dx, dw, db of Conv3x3Same (K2 forward, ReLU, bf16 out) against
    autograd of the float32 conv of the same bf16 values, with the kernel's
    output > 0 as the ReLU mask: within 1% of the largest |gradient|."""
    import torch.nn.functional as F
    from gandtr_tpu_torch.ops.vggconv import Conv3x3Same
    xb = x.detach().clone().requires_grad_(True)
    wb = w.detach().clone().requires_grad_(True)
    bf = b.detach().clone().requires_grad_(True)
    co = torch.randn(x.shape, generator=g, device=x.device)
    y = Conv3x3Same.apply(xb, wb, bf, True, torch.bfloat16)
    (y.float() * co).sum().backward()
    mask = (y > 0).detach()
    xr = x.detach().float().requires_grad_(True)
    wr = w.detach().float().requires_grad_(True)
    br = b.detach().clone().requires_grad_(True)
    yr = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), br,
                  padding=1).permute(0, 2, 3, 1)
    (torch.where(mask, yr, 0.0) * co).sum().backward()
    errs = {}
    for name, got, want in (("dx", xb.grad, xr.grad), ("dw", wb.grad, wr.grad),
                            ("db", bf.grad, br.grad)):
        d = float((got.float() - want).abs().max())
        errs[name] = d / float(want.abs().max())
        if d > 0.01 * float(want.abs().max()) + 1e-6:
            raise AssertionError("K2 backward %s at %s: %g" % (
                name, tuple(x.shape), d))
    print("K2 backward at %s: max |autograd - plain autograd| / max |plain| "
          "= dx %.3g, dw %.3g, db %.3g" % ((tuple(x.shape),)
                                            + tuple(errs.values())))


def k4_batch(dev, seed=0):
    """A (7, 364, 364) uint8 bucket with the rectangles imresize(., 362)
    leaves, each smooth content plus noise (so some bins clip), zero band."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((len(K4_RECTS), BUCKET, BUCKET), np.uint8)
    for i, (h, w) in enumerate(K4_RECTS):
        yy, xx = np.mgrid[:h, :w]
        base = (yy * (3 + i) + xx * (5 - i)) % 97 + 60
        imgs[i, :h, :w] = np.clip(base + rng.randint(-40, 40, (h, w)), 0, 255)
    return (torch.from_numpy(imgs).to(dev),
            torch.tensor(K4_RECTS, dtype=torch.int32, device=dev))


def check_k4(dev):
    """K4 (masked LUT build + interpolation) against its plain version on
    the card, bit for bit (band included: both write 0 there), at grids 8
    and 4 and clips 1.0 and 4.0, on the fine-tune's bucket and on a
    (4, 61, 75) one with a 3x5 rectangle (the pad larger than it), a 32x37
    one (h divides the grid, w does not: an extra tile row), a 40x64 one
    and the whole buffer; two launches bit-equal; one kernel on the stream
    a call; timings at the fine-tune's setting (clip 1.0, grid 8)."""
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    img, hw = k4_batch(dev)
    edge_rects = [(3, 5), (32, 37), (40, 64), (61, 75)]
    edge = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (len(edge_rects), 61, 75), dtype=np.uint8)).to(dev)
    edge_hw = torch.tensor(edge_rects, dtype=torch.int32, device=dev)
    worst = 0
    for x, xhw in ((img, hw), (edge, edge_hw)):
        for grid in (8, 4):
            for clip in (1.0, 4.0):
                got = kmasked.clahe_u8_masked_cuda(x, xhw, clip, grid)
                again = kmasked.clahe_u8_masked_cuda(x, xhw, clip, grid)
                want = clahe_u8_masked_plain(x, xhw, clip, grid)
                torch.cuda.synchronize()
                d = int((got.int() - want.int()).abs().max())
                worst = max(worst, d)
                print("K4 %s grid %d clip %.1f: max |kernel - plain| = %d, "
                      "repeat bit-equal %s" % (tuple(x.shape), grid, clip, d,
                                               torch.equal(got, again)))
                if d or not torch.equal(got, again):
                    raise AssertionError("K4 differs from its plain version")
    per_call = _stream_launches(
        lambda: kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8))
    print("K4 kernels on the stream a call (torch.profiler): %s" % per_call)
    if per_call != 1:
        raise AssertionError("K4 ran %s kernels in one call" % per_call)
    ms = cuda_ms(lambda: kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8),
                 reps=20)
    plain_ms = cuda_ms(lambda: clahe_u8_masked_plain(img, hw, 1.0, 8), reps=5)
    # the rectangles are read, the whole bucket written
    bound_s, bound_by = _clahe_bound(
        img.shape, sum(h * w for h, w in K4_RECTS), len(K4_RECTS))
    print("K4 at %s grid 8: kernel %.4f ms, plain %.4f ms, bound %.5f ms"
          % (tuple(img.shape), ms, plain_ms, bound_s * 1e3))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "stream_launches": per_call,
            "bound_by": bound_by}


def _kernels_a_call_fresh(cases):
    """Kernels on the stream for one call of each case [(module, function,
    args, kwargs)], counted by `_stream_launches` in a new process: in this
    one, once the served paths have run, the profiler's short traces come
    back empty more often than not."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="kernel_calls_") as d:
        path = os.path.join(d, "calls.pt")
        torch.save([(m, f, [a.cpu() if torch.is_tensor(a) else a
                            for a in args], kwargs)
                    for m, f, args, kwargs in cases], path)
        code = ("import json, sys; sys.path.insert(0, %r); "
                "import chip_smoke; "
                "print(json.dumps(chip_smoke._count_saved_calls(%r)))"
                % (str(ROOT), path))
        out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                             capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError("counting kernels a call failed: %s"
                           % out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _count_saved_calls(path):
    """The child of `_kernels_a_call_fresh`."""
    import importlib
    sys.path.insert(0, str(ROOT))
    counts = []
    for module, name, args, kwargs in torch.load(path):
        fn = getattr(importlib.import_module(module), name)
        args = [a.cuda() if torch.is_tensor(a) else a for a in args]
        counts.append(_stream_launches(lambda: fn(*args, **kwargs)))
    return counts


def _recording_calls(module, name, calls):
    """Replace `module.<name>` by a wrapper that appends each call's
    (args, kwargs) to `calls` (the tensors by reference: no copy, no
    synchronisation) and calls it; returns a function that puts it back."""
    original = getattr(module, name)

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(module, name, recording)
    return lambda: setattr(module, name, original)


def check_clahe_at_eval(calls, verbose=True):
    """K4 and K1 on the inputs the counted runs gave them (`calls`:
    {"K4": [(args, kwargs)], "K1": [...]}): each distinct bucket shape and
    set of rectangles (K4) or exact shape (K1) once, bit-equal to the plain
    version with one kernel a call, timed against its bound (a line a case
    when `verbose`). Returns {"K4": [case], "K1": [case]}, each case with
    the calls it stands for."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import (clahe_u8_masked_plain,
                                            clahe_u8_plain)
    wrappers = {"K4": kmasked.clahe_u8_masked_cuda,
                "K1": kclahe.clahe_u8_cuda}
    plains = {"K4": clahe_u8_masked_plain, "K1": clahe_u8_plain}
    distinct = {}
    for k in ("K4", "K1"):
        cases = {}
        for args, kwargs in calls[k]:
            rects = (tuple(map(tuple, args[1].tolist())) if k == "K4"
                     else ((args[0].shape[-2], args[0].shape[-1]),)
                     * (args[0].shape[0] if args[0].dim() == 3 else 1))
            key = (tuple(args[0].shape), rects) + tuple(args[2:]) \
                + tuple(sorted(kwargs.items()))
            cases.setdefault(key, [args, kwargs, 0])[2] += 1
        distinct[k] = sorted(cases.items(), key=lambda kv: str(kv[0]))
    per_call = iter(_kernels_a_call_fresh(
        [(wrappers[k].__module__, wrappers[k].__name__, args, kwargs)
         for k in distinct for _, (args, kwargs, _) in distinct[k]]))
    out = {}
    for k in distinct:
        out[k] = []
        for key, (args, kwargs, n) in distinct[k]:
            shape, rects = key[:2]
            case = _clahe_case(
                "%s eval %s, rectangles %s, %s" % (k, list(shape),
                                                   list(rects), key[2:]),
                lambda: wrappers[k](*args, **kwargs),
                lambda: plains[k](*args, **kwargs), shape,
                sum(h * w for h, w in rects), len(rects) if k == "K4" else 0,
                next(per_call), verbose)
            case.update(rects=[list(r) for r in rects], calls=n)
            out[k].append(case)
    return out


def _post_npy(url, img):
    """POST one npy image; returns (content type, body bytes, seconds)."""
    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST",
                                 headers={"Content-Type":
                                          "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        ctype = r.headers["Content-Type"]
    return ctype, body, time.perf_counter() - t0


def seeded_lw(dim=512, seed=1):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(dim, dim))
    return {"P": q.astype(np.float32),
            "m": (rng.randn(dim, 1) * 0.01).astype(np.float32)}


def serve_rounds(base, name, images, action=":predict"):
    """Rounds of N_REQ concurrent `action` requests (:predict, or
    :search?k=...) to model `name`; returns the (content type, body)
    answers of the last round in request order, and the timings of the
    rounds after the first."""
    url = base + "/v1/models/%s%s" % (name, action)
    walls, lat, last = [], [], None
    for rnd in range(ROUNDS + 1):
        res = [None] * N_REQ
        errs = []

        def call(i):
            try:
                res[i] = _post_npy(url, images[i])
            except Exception as e:  # reported below, fails the run
                errs.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(N_REQ)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errs or any(t.is_alive() for t in threads):
            raise RuntimeError("requests to %s failed: %r" % (name, errs))
        last = [(r[0], r[1]) for r in res]
        if rnd:  # round 0 warms cuDNN, the allocator and the bf16 copy
            walls.append(wall)
            lat += [r[2] for r in res]
    return last, {
        "images_per_s": N_REQ * ROUNDS / sum(walls),
        "ms_per_request": 1e3 * float(np.mean(lat)),
        "ms_per_round": 1e3 * float(np.median(walls)),
    }


def conv_gflop(features, h, w):
    """Multiply-add FLOPs (2 per MAC) of the 3x3 same convolutions of
    `features` on one h x w image, from the layer shapes."""
    flop = 0
    for layer in features:
        if isinstance(layer, torch.nn.MaxPool2d):
            h, w = h // 2, w // 2
        elif isinstance(layer, torch.nn.Conv2d):
            flop += 2 * h * w * layer.in_channels * layer.out_channels * 9
    return flop / 1e9


def stage_breakdown(model, images):
    """CUDA-event times of one batch of N_REQ through the served descriptor
    forward, stage by stage (after the main path, so warm)."""
    from gandtr_tpu_torch.data.transforms import split_device_transform
    from gandtr_tpu_torch.ops.resize import scale_resize
    dp = model.net.data_params
    _, pre = split_device_transform(dp["transforms"], dp["mean_std"])
    module = model.net.module
    ctx = {"msp": model.meta["msp"]}
    out = {}
    with torch.inference_mode():
        out["upload_ms"] = cuda_ms(
            lambda: torch.from_numpy(images).to("cuda"), reps=5)
        xu = torch.from_numpy(images).to("cuda")
        out["preprocess_ms"] = cuda_ms(
            lambda: pre(xu.to(torch.float32) / 255.0), reps=5)
        xn = pre(xu.to(torch.float32) / 255.0)
        for s in (1.0, 1 / np.sqrt(2), 0.5):
            xs = xn if s == 1.0 else scale_resize(xn, s)
            ms = cuda_ms(lambda: module(xs), reps=5)
            gflop = conv_gflop(module.features, xs.shape[1], xs.shape[2])
            out["vgg16_gem_scale_%.3f_ms" % s] = ms
            out["vgg16_scale_%.3f_conv_tflop_s" % s] = (
                gflop * xs.shape[0] / ms)
        out["net_apply_ms"] = cuda_ms(lambda: model.net.apply(xn, ctx=ctx),
                                      reps=5)
    return out


def generator_breakdown(model, images, direct_ms, round_ms):
    """CUDA-event times of one batch of N_REQ through the served generator
    forward (bf16), stage by stage; the PNG + HTTP share is the round's
    wall time less the direct call's."""
    from gandtr_tpu_torch.data.transforms import (device_quantize_rgb,
                                                  split_device_transform)
    from gandtr_tpu_torch.serving.service import encode_png
    dp = model.net.data_params
    _, pre = split_device_transform(dp["transforms"], dp["mean_std"])
    seq = model.net.compute_module().model
    blocks = [i for i, m in enumerate(seq)
              if type(m).__name__ == "ResnetBlock"]
    head, body, tail = seq[:blocks[0]], seq[blocks[0]:blocks[-1] + 1], \
        seq[blocks[-1] + 1:]
    out = {}
    with torch.inference_mode():
        out["upload_ms"] = cuda_ms(
            lambda: torch.from_numpy(images).to("cuda"), reps=5)
        xu = torch.from_numpy(images).to("cuda")
        out["preprocess_ms"] = cuda_ms(
            lambda: pre(xu.to(torch.float32) / 255.0).to(torch.bfloat16),
            reps=5)
        x = pre(xu.to(torch.float32) / 255.0).to(torch.bfloat16)
        out["head_ms"] = cuda_ms(lambda: head(x), reps=5)
        h = head(x)
        out["nine_blocks_ms"] = cuda_ms(lambda: body(h), reps=5)
        h = body(h)
        out["tail_ms"] = cuda_ms(lambda: tail(h), reps=5)
        y = tail(h)
        out["quantize_ms"] = cuda_ms(
            lambda: device_quantize_rgb(y, dp["mean_std"]), reps=5)
        u8 = device_quantize_rgb(y, dp["mean_std"]).cpu().numpy()
    # as the server does it, one handler thread per request; and the same
    # at zlib level 1 (what a faster setting would save; not used)
    for key, level in (("png_encode_8_threads_ms", None),
                       ("png_encode_8_threads_level1_ms", 1)):
        def encode(img, level=level):
            if level is None:
                return encode_png(img)
            from PIL import Image
            Image.fromarray(img).save(io.BytesIO(), format="PNG",
                                      compress_level=level)
        threads = [threading.Thread(target=encode, args=(img,))
                   for img in u8]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out[key] = 1e3 * (time.perf_counter() - t0)
    out["png_bytes_per_image"] = float(np.mean([len(encode_png(i))
                                                for i in u8]))
    out["direct_servable_ms"] = direct_ms
    out["png_and_http_ms"] = round_ms - direct_ms
    return out


def _k3_vs_plain(model, x):
    """The bf16 generator's float output with K3 and with K3's plain version
    in the nine blocks; also the plain path's own change when one input
    value moves by one uint8 level (the net's sensitivity)."""
    from gandtr_tpu_torch.ops import resblock
    from gandtr_tpu_torch.ops.resblock import fused_resblock_plain
    with torch.inference_mode():
        with_k3 = model.net.apply(x).float()
        kernel = resblock.fused_resblock
        resblock.fused_resblock = fused_resblock_plain
        try:
            with_plain = model.net.apply(x).float()
            x1 = x.clone()
            x1[0, HW[0] // 2, HW[1] // 2, 0] += 2.0 / 255
            nudged = model.net.apply(x1).float()
        finally:
            resblock.fused_resblock = kernel
    d = (with_k3 - with_plain).abs()
    return (float(d.max()), float(d.mean()),
            float((nudged - with_plain).abs().max()))


def generator_parity(model, images):
    """K3 against its plain version inside the bf16 generator, and the
    float32 generator (no K3) on the card against the port on the CPU on one
    256x256 image.

    The served generator's seeded normal_p2p weights (std 0.2, about 7x the
    Kaiming scale of its 256-channel convs) make a chaotic net: one input
    value moved by one uint8 level moves its output by up to about 0.3, so
    the bf16 K3's summation order, which moves a block's output by a bf16
    step here and there, and float32 summation order on the card against
    the CPU, are amplified far beyond what the kernel or the convolutions
    do. There the K3 comparison is held to its mean bound and the rest is
    printed. The same architecture initialised with kaiming_p2p (the hedngan
    scheme), where a one-level input change moves the output by about 0.06,
    is held to every bound: K3 vs plain within max 0.06 and mean 0.01, the
    float32 net on the card within 1e-4 of the CPU."""
    from gandtr_tpu_torch import hub
    x = torch.from_numpy(images).to("cuda").float() / 127.5 - 1.0
    xs = torch.from_numpy(np.ascontiguousarray(images[:1, :256, :256]))
    xs = xs.float() / 127.5 - 1.0
    out = {}
    for init in ("normal_p2p", "kaiming_p2p"):
        served = init == "normal_p2p"
        gen = model if served else hub._generator(
            "instance", pretrained=False, init_weights=init)
        gen.net.compute_dtype = torch.bfloat16
        mx, mean, nudge = _k3_vs_plain(gen, x)
        cpu = hub._generator("instance", pretrained=False, init_weights=init,
                             device="cpu")
        with torch.inference_mode():
            d32 = float((gen.net.module(xs.to("cuda")).cpu()
                         - cpu.net.module(xs)).abs().max())
        print("generator %s%s: bf16, K3 vs its plain version in the 9 blocks "
              "on %d images of %dx%d: max %.5f mean %.6f (the plain path "
              "moved by one input level: max %.5f); float32 on the card vs "
              "the CPU port, 256x256: max %.3g"
              % (init, " (served)" if served else "", N_REQ, HW[0], HW[1],
                 mx, mean, nudge, d32))
        if mean >= K3_MEAN or not (served or (mx < K3_MAX and d32 <= 1e-4)):
            raise AssertionError("generator %s: K3 vs plain %g / %g, float32 "
                                 "card vs CPU %g" % (init, mx, mean, d32))
        out[init] = {"k3_vs_plain_max": mx, "k3_vs_plain_mean": mean,
                     "one_level_nudge_max": nudge,
                     "f32_card_vs_cpu_max": d32}
    del x
    torch.cuda.empty_cache()
    return out


MEANSTD_GEN = [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]
MEANSTD_IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
# gandtr_tpu/scenarios/configs/iccv23/parameters/finetune.yml as published
# (network, learning; data.train cut to what the step reads), with the
# published checkpoints out of reach: augment.path null (seeded normal_p2p
# weights), embed.model.pretrained false (seeded), and the embed computing
# in bf16 (runtime.dtype, as bench.py:378 runs it).
# tests/test_torch_finetune.py holds it to the YAML file.
FINETUNE = {
    "network": {
        "type": "CirSequentialNetwork",
        "sequence": "augment,embed",
        "augment": {
            "type": "SingleNetwork",
            "path": None,
            "model": {"architecture": "official_resnet_generator",
                      "no_antialias": True, "no_antialias_up": True,
                      "input_nc": 3, "output_nc": 3, "n_blocks": 9,
                      "norm_layer": "batch"},
            "runtime": {
                "frozen": True,
                "wrappers": ("meanstd_post:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:"
                             "[[0.485,0.456,0.406],[0.229,0.224,0.225]],"
                             "clahepost:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:1.0,"
                             "cir_ratio_pass_through:0.25:anc"),
                "data": {"transforms": "pil2np | totensor | normalize",
                         "mean_std": MEANSTD_GEN}}},
        "embed": {
            "type": "SingleNetwork",
            "model": {"architecture": "cirnet", "cir_architecture": "vgg16",
                      "local_whitening": False, "pooling": "gem",
                      "pretrained": False, "regional": False,
                      "whitening": False},
            "initialize": False,
            "runtime": {
                "data": {"transforms": ("pil2np | apply_clahe:1.0 | "
                                        "totensor | normalize"),
                         "mean_std": MEANSTD_IMNET},
                "wrappers": "cirfaketuplebatch",
                "dtype": "bfloat16"}}},
    "learning": {
        "type": "TrainValLearning",
        "checkpoints": {
            "directory": "experiments/cirtorch/vgg16_${SCENARIO_NAME}",
            "checkpoint_every": 2, "store_every": 10},
        "training": {
            "type": "EpochTraining", "epochs": 40, "seed": 0,
            "deterministic": False, "dispatch_chunk": 8,
            "criterion": {"loss": "contrastive", "margin": 0.75},
            "epoch_iteration": {"type": "SupervisedEpoch",
                                "batch_average": False, "fakebatch": True,
                                "data": "train", "criterion": "default"},
            "optimizer": {"algorithm": "adam", "lr": 5.0e-07, "beta1": 0.9,
                          "beta2": 0.999, "weight_decay": 0.0005},
            "scheduler": {"algorithm": "gamma", "gamma": 0.99}}},
    "data": {"train": {"dataset": {"image_size": 362, "neg_num": 5},
                       "loader": {"batch_size": 5}}},
}
FT_T, FT_S = 5, 7              # tuples per step, images per tuple
FT_WARMUP, FT_STEPS = 2, 5
# parameters/eval.yml as shipped (tests/test_torch_eval.py holds it to the
# YAML): its `whitening: null` cannot run, so the eval phase points it at a
# seeded Lw pickle and `dir_main` at the synthetic set
EVAL = {
    "network": {
        "type": "SingleNetwork", "path": None,
        "model": {"architecture": "cirnet", "cir_architecture": "vgg16",
                  "pooling": "gem", "local_whitening": False,
                  "whitening": False, "regional": False},
        "runtime": {"wrappers": {"eval": {
            "0_cirwhiten": {"whitening": None, "dimensions": None},
            "1_cirmultiscale": {"scales": True}}}},
    },
    "data": {
        "image_size": 1024, "shape_bucket": 64,
        "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
        "mean_std": MEANSTD_IMNET,
    },
    "validation": {"dir_main": "data/test",
                   "datasets": ["roxford5k", "rparis6k", "247tokyo1k"]},
}
FT_LABELS = [-1, 1, 0, 0, 0, 0, 0]
FT_PASS = (0, 2, 4)            # tuples whose anchor takes the generator


def finetune_config(dtype="bfloat16"):
    import copy
    cfg = copy.deepcopy(FINETUNE)
    cfg["network"]["embed"]["runtime"]["dtype"] = dtype
    return cfg


def finetune_batch(dev, T=None, seed=0):
    """uint8 tuples (T, S, 364, 364, 3) of smooth content plus noise in the
    K4 rectangles (a different order in each tuple), their (h, w), the
    labels and the pass mask, on `dev`."""
    T = T or FT_T
    rng = np.random.RandomState(seed)
    imgs = np.zeros((T, FT_S, BUCKET, BUCKET, 3), np.uint8)
    hws = np.zeros((T, FT_S, 2), np.int32)
    for t in range(T):
        for s in range(FT_S):
            h, w = K4_RECTS[(s + t) % len(K4_RECTS)]
            yy, xx = np.mgrid[:h, :w]
            for c in range(3):
                base = (yy * (2 + s + c) + xx * (3 + t)) % 151 + 40
                imgs[t, s, :h, :w, c] = np.clip(
                    base + rng.randint(-30, 30, (h, w)), 0, 255)
            hws[t, s] = (h, w)
    labels = np.asarray([FT_LABELS] * T, np.float32)
    pmask = np.zeros((T, FT_S), bool)
    pmask[[t for t in FT_PASS if t < T], 0] = True
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (imgs, hws, labels, pmask))


def _descriptors(exp, x, masks, pmask, t=0):
    """Tuple t's descriptors (S, D) through the augment chain and the embed
    net, as the step computes them, without autograd."""
    models = exp["models"]
    with torch.no_grad():
        xa, ma = models["augment"].apply(
            x[t], ctx={"pass_mask": pmask[t]}, train=True,
            model_positions=(0,), mask=masks[t])
        return models["embed"].apply(xa, train=True, mask=ma).float()


def _embed_params(exp):
    return {k: v.detach().clone() for k, v in
            exp["models"]["embed"].module.named_parameters()}


def run_finetune(dev):
    """The fine-tune tuple step through its entry point: warm-up steps, then
    timed steps with every launch count set to 0 just before them."""
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    exp = build_finetune_experiment(finetune_config(), device=dev)
    batch = finetune_batch(dev)
    first = _embed_params(exp)
    aug_before = {k: v.clone() for k, v in
                  exp["models"]["augment"].module.state_dict().items()}
    state = exp["state"]
    for _ in range(FT_WARMUP):
        state, m = exp["step"](state, *batch)
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(FT_STEPS):
        state, m = exp["step"](state, *batch)
        losses.append(m["total"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    losses = [float(v) for v in losses]
    embed = exp["models"]["embed"].module
    moved = sum(int(not torch.equal(p.detach(), first[k]))
                for k, p in embed.named_parameters())
    aug_same = all(torch.equal(v, aug_before[k]) for k, v in
                   exp["models"]["augment"].module.state_dict().items())
    dtypes = sorted({str(p.dtype) for p in embed.parameters()})
    out = {"ms_per_step": 1e3 * secs / FT_STEPS,
           "images_per_s": FT_T * FT_S * FT_STEPS / secs,
           "losses": losses, "launches": counts,
           "embed_params_moved": moved,
           "embed_params": len(first), "master_dtypes": dtypes,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("fine-tune step (T=%d, S=%d, %d bucket, bf16 embed): %s"
          % (FT_T, FT_S, BUCKET, json.dumps(out)))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite fine-tune loss %s" % losses)
    if moved != len(first) or not aug_same or dtypes != ["torch.float32"]:
        raise AssertionError("fine-tune update: %d of %d embed parameters "
                             "moved, augment unchanged %s, master %s"
                             % (moved, len(first), aug_same, dtypes))
    if counts["K2"] != 2 * FT_T * FT_STEPS or \
            counts["K4"] != FT_T * FT_STEPS:
        raise AssertionError("fine-tune launches %s over %d steps"
                             % (counts, FT_STEPS))
    return exp, batch, out


def conv_flops(module, fn):
    """Multiply-add FLOPs (2 per MAC) of the convolutions `fn()` runs in
    `module`, counted from the shapes they see (forward hooks)."""
    total = [0]

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * k * m.out_channels // m.groups
        else:
            total[0] += 2 * out.numel() * k * m.in_channels // m.groups

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def finetune_breakdown(exp, batch):
    """CUDA-event times of one step's parts, the tuples' shares summed:
    staging, the generator on the anchors, the augment wrappers (meanstd,
    masked CLAHE by K4, the gate), the embed forward with the loss, the
    backward, the optimizer."""
    from gandtr_tpu_torch.ops import losses as L
    models = exp["models"]
    augment, embed = models["augment"], models["embed"]
    opt = exp["state"].optimizer
    imgs_u8, hws, labels, pmask = batch
    parts = {}
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    for rep in range(2):           # the second repetition is reported
        marks.clear()
        opt.zero_grad(set_to_none=True)
        mark("start")
        x, masks = exp["stage"](imgs_u8, hws)
        mark("stage")
        for t in range(x.shape[0]):
            with torch.no_grad():
                augment.module(x[t][:1], mask=masks[t][:1])
                mark("generator")
                augment.apply(x[t], ctx={"pass_mask": pmask[t]}, train=True,
                              model_positions=(), mask=masks[t])
                mark("wrappers")
                xa, ma = augment.apply(x[t], ctx={"pass_mask": pmask[t]},
                                       train=True, model_positions=(0,),
                                       mask=masks[t])
                mark("augment")
            d = embed.apply(xa, train=True, mask=ma)
            loss = L.contrastive_loss(d.T, labels[t], 1, margin=0.75)
            mark("embed_forward")
            loss.backward()
            mark("backward")
        opt.step()
        mark("optimizer")
        torch.cuda.synchronize()
    parts = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        parts[name] = parts.get(name, 0.0) + a.elapsed_time(b)
    total = marks[0][1].elapsed_time(marks[-1][1])
    # the "augment" mark re-ran the generator and the wrappers together, as
    # the step does; it is not part of one step's work
    step_ms = total - parts.pop("augment")
    out = {k + "_ms": v for k, v in parts.items()}
    out["step_ms"] = step_ms
    # the conv work of the step's generator and embed forwards, and its
    # rate over each part's time (K2's convs are counted by the hooks of
    # the conv modules whose weights they take, which they replace)
    with torch.no_grad():
        gen_flop = sum(conv_flops(augment.module, lambda t=t: augment.module(
            x[t][:1], mask=masks[t][:1])) for t in range(x.shape[0]))
    emb_flop = x.shape[0] * conv_flops(
        embed.module, lambda: _k2_free_embed(embed, x[0], masks[0]))
    out["generator_conv_gflop"] = gen_flop / 1e9
    out["generator_conv_tflop_s"] = gen_flop / parts["generator"] / 1e9
    out["embed_forward_conv_gflop"] = emb_flop / 1e9
    out["embed_forward_conv_tflop_s"] = (emb_flop / parts["embed_forward"]
                                         / 1e9)
    print("fine-tune breakdown (one step, T=%d, S=%d): %s"
          % (x.shape[0], x.shape[1], json.dumps(out)))
    return out


def _k2_free_embed(embed, x, mask):
    """The embed net's float32 forward on one tuple: every conv an
    nn.Conv2d call, so conv_flops sees the convs K2 runs on the path too."""
    with torch.no_grad():
        embed.module(x, mask=mask)


def finetune_parity(dev):
    """(a) The bf16 step with K2 and K4 swapped for their plain versions,
    on the same weights and batch: the loss within 1% relative, tuple 0's
    descriptors within 5e-3, and the updated conv weights' largest
    difference within 1e-4 of their largest value. (b) One tuple in float32 (no K2), on the
    card against the port on the CPU, the generator with kaiming_p2p
    weights: loss and descriptors within 1e-4. The seeded normal_p2p
    generator is a chaotic net (generator_parity), so its float32 summation
    order on the card against the CPU would show in its output, not the
    step's; the fine-tune's published generator is a trained one."""
    from gandtr_tpu_torch.models.init import initialize_weights
    from gandtr_tpu_torch.ops import clahe as clahe_ops
    from gandtr_tpu_torch.ops import vggconv
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    batch = finetune_batch(dev, T=2, seed=1)
    res = {}
    for name in ("kernels", "plain"):
        k2, k4 = vggconv.conv3x3_same, clahe_ops.clahe_u8_masked
        if name == "plain":
            vggconv.conv3x3_same = (lambda x, w, b=None, relu=False,
                                    out_dtype=None: vggconv.
                                    conv3x3_same_plain(x, w, b, relu,
                                                       out_dtype))
            clahe_ops.clahe_u8_masked = clahe_ops.clahe_u8_masked_plain
        try:
            reset_launches()
            exp = build_finetune_experiment(finetune_config(), device=dev)
            x, masks = exp["stage"](batch[0], batch[1])
            desc = _descriptors(exp, x, masks, batch[3])
            _, m = exp["step"](exp["state"], *batch)
            res[name] = (float(m["total"]), desc, _embed_params(exp),
                         launches())
        finally:
            vggconv.conv3x3_same, clahe_ops.clahe_u8_masked = k2, k4
    (lk, dk, pk, ck), (lp, dp, pp, cp) = res["kernels"], res["plain"]
    if cp["K2"] or cp["K4"] or not (ck["K2"] and ck["K4"]):
        raise AssertionError("parity launches: kernels %s, plain %s"
                             % (ck, cp))
    rel_loss = abs(lk - lp) / abs(lp)
    d_desc = float((dk - dp).abs().max())
    # Adam's first step moves each parameter by about lr (5e-7; 5e-6 for
    # GeM's p) whatever its gradient's size, so a gradient near 0 whose sign
    # differs moves a zero-initialised bias by 2 lr: the largest |diff| is
    # read in units of lr, and relative to the weights' own size
    lr = FINETUNE["learning"]["training"]["optimizer"]["lr"]
    d_par_lr = max(float((pk[k] - pp[k]).abs().max()) for k in pp) / lr
    d_par = max(float((pk[k] - pp[k]).abs().max() / pp[k].abs().max())
                for k in pp if pp[k].dim() > 1)
    print("fine-tune parity (bf16, K2 and K4 vs their plain versions, T=2): "
          "loss %.7g vs %.7g (rel %.3g), tuple-0 descriptors max |diff| "
          "%.3g; updated embed parameters: max |diff| %.3g lr, and over "
          "the conv weights max |diff| / max |weight| %.3g"
          % (lk, lp, rel_loss, d_desc, d_par_lr, d_par))
    if not (rel_loss <= 1e-2 and d_desc <= 5e-3 and d_par <= 1e-4):
        raise AssertionError("fine-tune kernels vs plain: loss %g desc %g "
                             "weights %g" % (rel_loss, d_desc, d_par))

    torch.set_num_threads(os.cpu_count() or 1)
    out32 = {}
    for d in (dev, torch.device("cpu")):
        b = tuple(a[:1].to(d) for a in batch)
        exp = build_finetune_experiment(finetune_config(None), device=d)
        initialize_weights(exp["models"]["augment"].module, "kaiming_p2p", 0)
        x, masks = exp["stage"](b[0], b[1])
        desc = _descriptors(exp, x, masks, b[3]).cpu()
        t0 = time.perf_counter()
        _, m = exp["step"](exp["state"], *b)
        loss = float(m["total"])
        out32[d.type] = (loss, desc, time.perf_counter() - t0)
    (lg, dg, _), (lc, dc, cpu_s) = out32["cuda"], out32["cpu"]
    d32 = float((dg - dc).abs().max())
    print("fine-tune float32, one tuple, card vs CPU port: loss %.8g vs %.8g "
          "(|diff| %.3g), descriptors max |diff| %.3g (CPU step %.1f s)"
          % (lg, lc, abs(lg - lc), d32, cpu_s))
    if abs(lg - lc) > 1e-4 or d32 > 1e-4:
        raise AssertionError("fine-tune float32 card vs CPU: loss %g desc %g"
                             % (abs(lg - lc), d32))
    torch.cuda.empty_cache()
    return {"bf16_loss_rel": rel_loss, "bf16_desc_max": d_desc,
            "bf16_param_max_lr": d_par_lr, "bf16_weight_max_rel": d_par,
            "f32_loss_abs": abs(lg - lc),
            "f32_desc_max": d32}


# ---- the fine-tune loop of finetune.yml

# finetune.yml's data.train and output sections as published
# (tests/test_torch_finetune_loop.py holds finetune_loop_config to the YAML)
FINETUNE_DATA_TRAIN = {
    "dataset": {"name": "CirDiverseAnchors", "dataset": "retrieval-SfM-120k",
                "dataset_pkl": ("data/train/retrieval-SfM-120k/"
                                "retrieval-SfM-120k.pkl"),
                "image_dir": "data/train/retrieval-SfM-120k/ims",
                "image_size": 362, "neg_num": 5, "pool_size": 22000,
                "qpool_size": 10000, "query_size": 2000,
                "similar_exclude": 0.2, "similar_include": 0.8,
                "split": "train"},
    "loader": {"batch_size": 5}}
FINETUNE_OUTPUT = {"learning": {"progress": {"print_each": 100}}}
# the loop phase's cuts of scale (PERF.md §4); every other value published
LOOP_EPOCHS = 2
LOOP_CUTS = {"query_size": 20, "qpool_size": 40, "pool_size": 150}
LOOP_CHECKPOINTS = {"checkpoint_every": 1, "store_every": 2}
# the synthetic tuple set: 60 clusters of 3 photos, (h, w) with a longest
# side of 362, so imresize(., 362) keeps them
LOOP_CLUSTERS, LOOP_PER = 60, 3
LOOP_SHAPES = [(272, 362), (362, 272), (362, 362), (362, 204)]
# a published epoch: 2000 tuples / 5 a step, qpool 10,000 anchors (a
# quarter through the generator) and a pool of 22,000
PUB_STEPS, PUB_QPOOL, PUB_POOL, PUB_QUERIES = 400, 10000, 22000, 2000


def finetune_loop_config(dataset_pkl, image_dir):
    """finetune.yml with the seeded weights and bf16 embed of
    `finetune_config`, its data and output sections, and the loop's cuts."""
    import copy
    cfg = finetune_config()
    cfg["learning"]["training"]["epochs"] = LOOP_EPOCHS
    cfg["learning"]["checkpoints"].update(LOOP_CHECKPOINTS)
    cfg["data"] = {"train": copy.deepcopy(FINETUNE_DATA_TRAIN)}
    cfg["data"]["train"]["dataset"].update(
        LOOP_CUTS, dataset_pkl=dataset_pkl, image_dir=image_dir)
    cfg["output"] = copy.deepcopy(FINETUNE_OUTPUT)
    return cfg


# the finetune_r101 target (train/_train.yml:49-76): step 1 is the loop
# above with a ResNet-101 embed and margin 0.85 (R101_EPOCHS epochs), step
# 2 learns Lw by whitening.yml from its embed_best.ckpt, step 4 evaluates
# by eval.yml from both; tests/test_torch_finetune_r101.py holds them to
# the YAML files
R101_EPOCHS = 2
R101_TRAIN = {"network.embed.model.cir_architecture": "resnet101",
              "learning.training.criterion.margin": 0.85}
WHITENING = {
    "whitening": {"type": "lw", "dataset_pkl": None, "directory": None},
    "network": {
        "type": "SingleNetwork", "path": None,
        "model": {"architecture": "cirnet", "cir_architecture": "resnet101",
                  "pooling": "gem", "local_whitening": False,
                  "whitening": False, "regional": False},
        "runtime": {"wrappers": "cirmultiscale:True"}},
    "data": {"image_dir": None, "image_size": 1024, "shape_bucket": 64,
             "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
             "mean_std": MEANSTD_IMNET},
    "output": {"dimensions": 2048},
}


def _set_dotted(cfg, key, value):
    *head, last = key.split(".")
    for k in head:
        cfg = cfg[k]
    cfg[last] = value


def finetune_r101_config(dataset_pkl, image_dir):
    """finetune_loop_config with finetune_r101's step 1 overrides."""
    cfg = finetune_loop_config(dataset_pkl, image_dir)
    cfg["learning"]["training"]["epochs"] = R101_EPOCHS
    for key, value in R101_TRAIN.items():
        _set_dotted(cfg, key, value)
    return cfg


def r101_whitening_params(net_path, whiten_pkl, image_dir, directory):
    """whitening.yml's sections with finetune_r101's step 2 overrides: the
    step 1 network file, the whitening set and the experiment directory."""
    import copy
    params = copy.deepcopy(WHITENING)
    params["whitening"].update(dataset_pkl=whiten_pkl, directory=directory)
    params["network"]["path"] = net_path
    params["data"]["image_dir"] = image_dir + "/*"
    return params


def cid_path(cid):
    """The reference's cid tree: cid[-2:]/cid[-4:-2]/cid[-6:-4]/cid."""
    return "/".join([cid[-2:], cid[-4:-2], cid[-6:-4], cid])


def make_tuple_set(root, seed=0, cids=False):
    """A seeded retrieval-SfM-style tuple set under root: LOOP_CLUSTERS
    clusters of LOOP_PER JPEGs (a scene of its own: a hue and 3 plane waves,
    each photo at another offset, with noise), shapes cycling through
    LOOP_SHAPES; root/db.pkl in the reference's form {"train": {"ids",
    "cluster", "qidxs", "pidxs"}}, each cluster's first photo a query and
    its second the positive. With `cids`, the photos are named by 32-digit
    hex cids in the reference's cid tree under root/ims, and the database
    is root/retrieval-SfM-120k.pkl {"train", "val"} in the cids form, as
    SfM-120k ships. Returns the pkl's path."""
    import pickle
    from PIL import Image
    rng = np.random.RandomState(seed)
    ims = os.path.join(root, "ims")
    os.makedirs(ims, exist_ok=True)
    ids, cluster = [], []
    for c in range(LOOP_CLUSTERS):
        freq = rng.uniform(4, 30, (3, 2)) * rng.choice([-1, 1], (3, 2))
        phase = rng.uniform(0, 2 * np.pi, (3, 3))
        base = 0.5 + 0.25 * np.cos(2 * np.pi * (c / LOOP_CLUSTERS
                                                + np.array([0, 1, 2]) / 3))
        for k in range(LOOP_PER):
            h, w = LOOP_SHAPES[(c * LOOP_PER + k) % len(LOOP_SHAPES)]
            dy, dx = rng.uniform(0, 0.2, 2)
            yy = np.arange(h)[:, None, None] / 362.0 + dy
            xx = np.arange(w)[None, :, None] / 362.0 + dx
            img = np.broadcast_to(base, (h, w, 3)).copy()
            for j in range(3):
                img += 0.1 * np.sin(freq[j, 0] * yy + freq[j, 1] * xx
                                    + phase[j])
            img += rng.rand(h, w, 3) * 0.15
            name = "c%02d_%d.jpg" % (c, k)
            if cids:
                name = "%032x" % (0x5f3759df * (1 + len(ids)) + seed)
                os.makedirs(os.path.dirname(os.path.join(
                    ims, cid_path(name))), exist_ok=True)
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(ims, cid_path(name) if cids else name),
                format="JPEG", quality=90)
            ids.append(name)
            cluster.append(c)
    db = {"cids" if cids else "ids": ids, "cluster": cluster,
          "qidxs": [LOOP_PER * c for c in range(LOOP_CLUSTERS)],
          "pidxs": [LOOP_PER * c + 1 for c in range(LOOP_CLUSTERS)]}
    path = os.path.join(root, "retrieval-SfM-120k.pkl" if cids else "db.pkl")
    with open(path, "wb") as f:
        pickle.dump({"train": db, "val": db} if cids else {"train": db}, f)
    return path


def _extraction_batches(calls, images, ratio, label_re, batch):
    """The mining extraction batches of `calls` ([(idxs, label)]): each
    call's gated images and its others in batches of `batch` apart."""
    import re
    from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                    metadata_name)
    n = 0
    for idxs, label in calls:
        gate = re.match(label_re, label) is not None
        aug = sum(gate and cir_hash_passthrough(metadata_name(images[i]),
                                                ratio) for i in idxs)
        n += -(-aug // batch) + -(-(len(idxs) - aug) // batch)
    return n


def _instrument_loop(exp, rec):
    """Wrap the loop's parts on their instances to time them and record
    what the checks read: per epoch the mining, the steps (the epoch's run
    less its mining), the checkpoint save and the events, each ending on
    the host's wait; each loss; the extraction calls; the tuples; the host
    time the loader threads spend building tuples; torch.profiler over
    epoch 2's steps; and the state after epoch 1 with a copy of its
    directory."""
    import copy
    import shutil
    from torch.profiler import ProfilerActivity, profile
    training, dataset = exp["training"], exp["dataset"]
    loop = training.loop
    orig = {"prepare": dataset.prepare_epoch, "run": loop.run_epoch,
            "save": exp["checkpoints"].save_epoch,
            "norms": training._log_weight_norms,
            "close": exp["events"].close_epoch, "step": loop.step_fn,
            "extract": dataset.extract_fn, "hook": training.state_hook,
            "load": dataset._load_tuple_u8, "args": loop.batch_to_args}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            rec["epochs"][-1][key] += time.perf_counter() - t0
            return out
        return wrapper

    def prepare():
        t0 = time.perf_counter()
        out = orig["prepare"]()
        torch.cuda.synchronize()
        rec["epochs"][-1]["mining_s"] += time.perf_counter() - t0
        rec["tuples"].append(list(dataset.tuples))
        rec["marks"].append([("mined", time.perf_counter())])
        if len(rec["epochs"]) == 2:
            rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
            rec["prof"].__enter__()
            rec["prof_t0"] = time.perf_counter()
        return out

    def run_epoch(state, epoch):
        rec["epochs"].append(dict.fromkeys(
            ("mining_s", "run_s", "checkpoint_s", "events_s"), 0.0))
        t0 = time.perf_counter()
        state = orig["run"](state, epoch)
        rec["epochs"][-1]["run_s"] = time.perf_counter() - t0
        if epoch == 2:
            torch.cuda.synchronize()
            rec["prof_wall"] = time.perf_counter() - rec["prof_t0"]
            rec["prof"].__exit__(None, None, None)
        return state

    def step_fn(state, *args):
        state, m = orig["step"](state, *args)
        rec["losses"].append(m["total"])
        rec["marks"][-1].append(("stepped", time.perf_counter()))
        return state, m

    def batch_to_args(batch):
        rec["marks"][-1].append(("batch", time.perf_counter()))
        return orig["args"](batch)

    def extract(idxs, label="anc-mine"):
        rec["extract_calls"].append((list(idxs), label))
        return orig["extract"](idxs, label=label)

    def load(idxs):
        t0 = time.perf_counter()
        out = orig["load"](idxs)
        rec["loader_s"].append(time.perf_counter() - t0)
        return out

    def hook(state, epoch):
        if epoch == 1:
            embed = state.models["embed"].module
            rec["after1"] = {
                "params": {k: p.detach().clone()
                           for k, p in embed.named_parameters()},
                "optimizer": copy.deepcopy(state.optimizer.state_dict()),
                "step": state.step}
            shutil.copytree(exp["checkpoints"].directory, rec["copy_dir"],
                            symlinks=True)
        return orig["hook"](state, epoch)

    dataset.prepare_epoch = prepare
    dataset.extract_fn = extract
    extract.holder = orig["extract"].holder
    dataset._load_tuple_u8 = load
    loop.run_epoch = run_epoch
    loop.step_fn = step_fn
    loop.batch_to_args = batch_to_args
    exp["checkpoints"].save_epoch = timed("checkpoint_s", orig["save"])
    training._log_weight_norms = timed("events_s", orig["norms"])
    exp["events"].close_epoch = timed("events_s", orig["close"])
    training.state_hook = hook


def _partition_check(exp, images, dev):
    """The gate-partitioned extraction of 16 images (8 through the
    generator, 8 not) against one mixed batch of them through the same
    chain: max |diff| (the bf16 bound of the step, 5e-3)."""
    from gandtr_tpu_torch.data.cir_datasets import load_u8_padded
    from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                    metadata_name)
    flags = [cir_hash_passthrough(metadata_name(p), 0.25) for p in images]
    gated = [i for i, f in enumerate(flags) if f][:8]
    plain = [i for i, f in enumerate(flags) if not f][:8]
    idxs = [i for pair in zip(gated, plain) for i in pair]
    got = exp["dataset"].extract_fn(idxs, label="anc-mine")
    ds = exp["dataset"]
    arrs, hws = zip(*(load_u8_padded(images[i], ds.image_size, ds.pad_size)
                      for i in idxs))
    models = exp["models"]
    with torch.inference_mode():
        x, m = exp["stage"](
            torch.from_numpy(np.stack(arrs))[None].to(dev),
            torch.from_numpy(np.asarray(hws, np.int32))[None].to(dev))
        y, m = models["augment"].apply(
            x[0], ctx={"pass_mask": torch.tensor([flags[i] for i in idxs],
                                                 device=dev)},
            train=True, mask=m[0])
        want = models["embed"].apply(y, train=False, mask=m).float()
    return float(np.abs(got - want.cpu().numpy().T).max())


def _extraction_rates(exp, images):
    """Images a second of the mining extraction, for the generator
    partition (the gated images, label anc-mine) and the pass-through one
    (the others, label neg-pool-mine), each a warm call ending in the
    host's copy of the descriptors."""
    from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                    metadata_name)
    flags = [cir_hash_passthrough(metadata_name(p), 0.25) for p in images]
    out = {}
    for name, idxs, label in (
            ("generator", [i for i, f in enumerate(flags) if f], "anc-mine"),
            ("pass_through", [i for i, f in enumerate(flags) if not f][:128],
             "neg-pool-mine")):
        exp["dataset"].extract_fn(idxs[:8], label=label)
        t0 = time.perf_counter()
        exp["dataset"].extract_fn(idxs, label=label)
        out[name] = {"images": len(idxs),
                     "images_per_s": len(idxs) / (time.perf_counter() - t0)}
    return out


def protocol_mining(dev, seed=0):
    """Host seconds of one published epoch's mining on seeded random unit
    descriptors: rank_descriptors of (512, 22,000) pool against (512,
    2,000) queries on the card plus search_hard_negatives with nnum 5, and
    select_diverse_queries picking 2,000 of a 10,000 pool."""
    from gandtr_tpu_torch.data import mining
    rng = np.random.RandomState(seed)

    def unit(n):
        v = rng.randn(512, n).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    qpool, pool = unit(PUB_QPOOL), unit(PUB_POOL)
    clusters = list(np.arange(PUB_QPOOL + PUB_POOL) // 10)
    t0 = time.perf_counter()
    sel, _ = mining.select_diverse_queries(qpool, PUB_QUERIES, 0.2, 0.8,
                                           rng=np.random.RandomState(seed))
    select_s = time.perf_counter() - t0
    qidxs = sel
    idxs2images = list(range(PUB_QPOOL, PUB_QPOOL + PUB_POOL))
    t0 = time.perf_counter()
    nidxs, _ = mining.search_hard_negatives(
        qpool[:, sel], pool, qidxs, idxs2images, clusters, 5, device=dev)
    search_s = time.perf_counter() - t0
    if len(set(sel)) != PUB_QUERIES or any(len(n) != 5 for n in nidxs):
        raise AssertionError("protocol mining picked %d queries"
                             % len(set(sel)))
    return {"select_diverse_queries_s": select_s,
            "rank_and_search_s": search_s,
            "host_mining_s": select_s + search_s}


def run_finetune_loop(dev, bare_step_ms):
    """finetune.yml's loop through build_finetune_experiment on the card:
    two epochs on a seeded synthetic tuple set (the cuts of LOOP_CUTS),
    every launch count set to 0 just before `training.run` and read just
    after; then the checks, the resume, the extraction rates, the mining
    at protocol scale and the projection of a published epoch."""
    import shutil
    import tempfile
    from gandtr_tpu_torch.learning.network import build_single_net
    from gandtr_tpu_torch.scenarios.finetune_build import (
        EXTRACT_BATCH, build_finetune_experiment)
    tmp = tempfile.mkdtemp(prefix="ftloop_", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        pkl = make_tuple_set(tmp)
        cfg = finetune_loop_config(pkl, os.path.join(tmp, "ims"))
        exp = build_finetune_experiment(cfg, os.path.join(tmp, "exp"),
                                        device=dev)
        setup_s = time.perf_counter() - t0
        images = exp["dataset"].images
        rec = {"epochs": [], "losses": [], "tuples": [], "extract_calls": [],
               "loader_s": [], "marks": [],
               "copy_dir": os.path.join(tmp, "exp_after1")}
        _instrument_loop(exp, rec)
        first = {k: v.detach().clone() for k, v in
                 exp["models"]["embed"].module.named_parameters()}
        aug0 = {k: v.clone() for k, v in
                exp["models"]["augment"].module.state_dict().items()}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = exp["training"].run(exp["state"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()

        # --- what the run must show
        losses = [float(v) for v in rec["losses"]]
        steps = len(losses)
        per_epoch = len(exp["loader"])
        if steps != LOOP_EPOCHS * per_epoch or not np.all(np.isfinite(losses)):
            raise AssertionError("loop losses %s" % losses)
        embed = state.models["embed"].module
        moved = sum(int(not torch.equal(p.detach(), first[k]))
                    for k, p in embed.named_parameters())
        aug_same = all(torch.equal(v, aug0[k]) for k, v in
                       state.models["augment"].module.state_dict().items())
        if moved != len(first) or not aug_same:
            raise AssertionError("loop update: %d of %d embed parameters "
                                 "moved, augment unchanged %s"
                                 % (moved, len(first), aug_same))
        clusters = exp["dataset"].db["cluster"]
        for tuples in rec["tuples"]:
            for q, _, negs in tuples:
                if len(negs) != 5 or len({clusters[n] for n in negs}
                                         | {clusters[q]}) != 6:
                    raise AssertionError("negatives of %d: %s" % (q, negs))
        batches = _extraction_batches(rec["extract_calls"], images, 0.25,
                                      "anc", EXTRACT_BATCH)
        t = cfg["data"]["train"]["loader"]["batch_size"]
        want = {"K2": 2 * (batches + t * steps), "K4": batches + t * steps}
        if (counts["K2"], counts["K4"]) != (want["K2"], want["K4"]):
            raise AssertionError("loop launches %s, expected %s (%d "
                                 "extraction batches, %d steps of %d tuples)"
                                 % (counts, want, batches, steps, t))
        print("fine-tune loop launches: %s = K4 once and K2 twice for each "
              "of %d mining extraction batches and each of %d tuples in %d "
              "steps" % (json.dumps(counts), batches, t * steps, steps))

        # --- the parts of the run and the card's busy share
        prof = rec.pop("prof")
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        ep2 = rec["epochs"][1]
        steps_s = ep2["run_s"] - ep2["mining_s"]
        loop_step_ms = 1e3 * steps_s / per_epoch
        # epoch 2 on the host's clock: the wait for the first batch after
        # mining, and the host's time from one step's return to the next's
        marks = rec["marks"][1]
        first = next(t for k, t in marks if k == "batch") - marks[0][1]
        stepped = [t for k, t in marks if k == "stepped"]
        out = {"setup_s": setup_s, "run_s": wall, "steps": steps,
               "losses": losses, "launches": counts,
               "extraction_batches": batches,
               "epochs": [{"mining_s": e["mining_s"],
                           "steps_s": e["run_s"] - e["mining_s"],
                           "checkpoint_s": e["checkpoint_s"],
                           "events_s": e["events_s"]}
                          for e in rec["epochs"]],
               "loop_ms_per_step_epoch2": loop_step_ms,
               "bare_step_ms": bare_step_ms,
               "epoch2_first_batch_wait_ms": 1e3 * first,
               "epoch2_host_ms_between_steps": 1e3 * float(
                   np.mean(np.diff(stepped))),
               "epoch2_steps_busy_share": busy_us / 1e6 / rec["prof_wall"],
               "epoch2_steps_profiled_wall_s": rec["prof_wall"],
               "loader_host_ms_per_step": 1e3 * sum(rec["loader_s"]) / steps,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

        # --- resume from the directory as it was after epoch 1
        rexp = build_finetune_experiment(cfg, rec["copy_dir"], device=dev)
        rstate, start = rexp["training"].resume_or_start(rexp["state"])
        after1 = rec["after1"]
        same_params = all(torch.equal(p.detach(), after1["params"][k]) for k, p
                          in rstate.models["embed"].module.named_parameters())
        got_opt = rstate.optimizer.state_dict()["state"]
        same_moments = all(torch.equal(got_opt[i][k], v)
                           for i, s in after1["optimizer"]["state"].items()
                           for k, v in s.items())
        if start != 2 or rstate.step != after1["step"] or not (
                same_params and same_moments):
            raise AssertionError("resume: start %d, step %d vs %d, params "
                                 "%s, moments %s" % (start, rstate.step,
                                                     after1["step"],
                                                     same_params,
                                                     same_moments))
        rlosses = []
        rstep = rexp["training"].loop.step_fn

        def counted(s, *args):
            s, m = rstep(s, *args)
            rlosses.append(m["total"])
            return s, m

        rexp["training"].loop.step_fn = counted
        rexp["training"].run(rstate, start_epoch=start)
        rlosses = [float(v) for v in rlosses]
        if len(rlosses) != per_epoch or not np.all(np.isfinite(rlosses)):
            raise AssertionError("resumed epoch 2 losses %s" % rlosses)
        out["resume"] = {"start_epoch": start, "params_bit_equal": True,
                         "adam_moments_bit_equal": True,
                         "epoch2_losses": rlosses}
        del rexp, rstate

        # --- embed_best.ckpt in a fresh GeM-VGG16, and mining after the
        # steps against it (the bf16 cast copy follows the weights)
        best = exp["checkpoints"].load_net("embed", "_best")
        fresh = build_single_net(cfg["network"]["embed"], device="cpu")
        fresh.module.load_state_dict(best["model_state"], strict=True)
        fresh.module.to(dev)
        from gandtr_tpu_torch.data.cir_datasets import load_u8_padded
        ds = exp["dataset"]
        arrs, hws = zip(*(load_u8_padded(images[i], ds.image_size,
                                         ds.pad_size) for i in range(8)))
        with torch.inference_mode():
            x, m = exp["stage"](
                torch.from_numpy(np.stack(arrs))[None].to(dev),
                torch.from_numpy(np.asarray(hws, np.int32))[None].to(dev))
            d_trained = exp["models"]["embed"].apply(x[0], train=False,
                                                     mask=m[0])
            d_fresh = fresh.apply(x[0], train=False, mask=m[0])
        if not torch.equal(d_trained, d_fresh):
            raise AssertionError("embed_best.ckpt descriptors differ by %g"
                                 % float((d_trained.float()
                                          - d_fresh.float()).abs().max()))
        del fresh

        out["partition_vs_one_batch_max"] = _partition_check(exp, images,
                                                             dev)
        if out["partition_vs_one_batch_max"] > 5e-3:
            raise AssertionError("partitioned extraction vs one batch: %g"
                                 % out["partition_vs_one_batch_max"])
        out["extraction"] = _extraction_rates(exp, images)
        out["protocol_mining"] = protocol_mining(dev)
        del exp, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    gen_rate = out["extraction"]["generator"]["images_per_s"]
    plain_rate = out["extraction"]["pass_through"]["images_per_s"]
    gated = PUB_QPOOL // 4
    proj = {"steps_s": PUB_STEPS * loop_step_ms / 1e3,
            "extraction_generator_s": gated / gen_rate,
            "extraction_pass_through_s": (PUB_QPOOL - gated + PUB_POOL)
            / plain_rate,
            "host_mining_s": out["protocol_mining"]["host_mining_s"]}
    proj["epoch_s"] = sum(proj.values())
    out["projection_published_epoch"] = proj
    print("fine-tune loop (finetune.yml, 2 epochs, query_size 20, qpool_size "
          "40, pool_size 150, bf16 embed): %s" % json.dumps(out))
    print("PROJECTION, not a measurement: a published epoch (400 steps, "
          "32,000 mining extractions of which 2,500 through the generator, "
          "mining at 2,000 x 22,000) from this run's rates: %s"
          % json.dumps(proj))
    return out


# ---- the retrieval eval of eval.yml

EVAL_SHAPES = [(768, 1024), (1024, 768), (683, 1024), (1024, 683),
               (576, 1024), (600, 800), (960, 1280)]   # (h, w) photos
EVAL_DB, EVAL_Q = 48, 6


def make_eval_set(root, seed=0, name="roxford5k", n_db=EVAL_DB,
                  n_q=EVAL_Q):
    """A seeded synthetic roxford5k-style set under root/<name>: n_q
    scenes, each seen by one query (cropped to a bbx) and by n_db // n_q
    database photos at other offsets, with noise; sizes cycle through
    EVAL_SHAPES (1280x960 is downsized by LANCZOS, 800x600 kept). Each
    query's gnd lists 4 easy, 3 hard and 1 junk photo of its scene (for
    247tokyo1k, the one-protocol form: its scene's photos "ok", no junk).
    Returns the database paths."""
    import pickle
    from PIL import Image
    rng = np.random.RandomState(seed)
    jpg = os.path.join(root, name, "jpg")
    os.makedirs(jpg)
    # a scene: a hue of its own and 4 plane waves, in units of the photo's
    # longest side (so a downsized photo shows the same scene)
    hues = np.linspace(0, 1, n_q, endpoint=False)
    scenes = [((rng.uniform(2, 14, (4, 2)) * rng.choice([-1, 1], (4, 2))
                * 2 * np.pi).astype(np.float32),
               rng.uniform(0, 2 * np.pi, (4, 3)).astype(np.float32),
               (0.5 + 0.25 * np.cos(2 * np.pi * (hues[k] + np.array(
                   [0, 1 / 3, 2 / 3])))).astype(np.float32))
              for k in range(n_q)]

    def photo(scene, h, w, path):
        freq, phase, base = scenes[scene]
        side = float(max(h, w))
        dy, dx = rng.uniform(0, 0.3, 2).astype(np.float32)
        yy = np.arange(h, dtype=np.float32)[:, None, None] / side + dy
        xx = np.arange(w, dtype=np.float32)[None, :, None] / side + dx
        img = np.broadcast_to(base, (h, w, 3)).copy()
        for k in range(len(freq)):
            img += np.float32(0.08) * np.sin(freq[k, 0] * yy
                                             + freq[k, 1] * xx + phase[k])
        img += rng.rand(h, w, 3).astype(np.float32) * 0.15
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            path, quality=90)

    per = n_db // n_q
    imlist, db_paths = [], []
    for i in range(n_db):
        im = "db%02d" % i
        db_paths.append(os.path.join(jpg, im + ".jpg"))
        photo(i // per, *EVAL_SHAPES[i % len(EVAL_SHAPES)], db_paths[-1])
        imlist.append(im)
    qimlist, gnd = [], []
    for q in range(n_q):
        h, w = EVAL_SHAPES[(q + 3) % len(EVAL_SHAPES)]
        photo(q, h, w, os.path.join(jpg, "q%d.jpg" % q))
        qimlist.append("q%d" % q)
        own = list(range(q * per, (q + 1) * per))
        if name == "247tokyo1k":
            gnd.append({"ok": np.asarray(own), "junk": np.asarray([], int)})
            continue
        gnd.append({"easy": np.asarray(own[:4]), "hard": np.asarray(own[4:7]),
                    "junk": np.asarray(own[7:]),
                    "bbx": [w // 10, h // 8, w - w // 10, h - h // 8]})
    with open(os.path.join(root, name, "gnd_%s.pkl" % name), "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    return db_paths


def eval_params(root, lw_path, shape_bucket):
    """EVAL with the seeded Lw, the synthetic set and `shape_bucket`."""
    import copy
    params = copy.deepcopy(EVAL)
    params["network"]["runtime"]["wrappers"]["eval"]["0_cirwhiten"][
        "whitening"] = lw_path
    params["data"]["shape_bucket"] = shape_bucket
    params["validation"] = {"dir_main": root, "datasets": ["roxford5k"]}
    return params


def _recorded(stage, run):
    """run() while `stage.evaluate_dataset` records what it returns:
    (run's result, [(metrics, aps, vecs, qvecs)])."""
    records, original = [], stage.evaluate_dataset

    def recording(*args, **kwargs):
        records.append(original(*args, **kwargs))
        return records[-1]

    stage.evaluate_dataset = recording
    try:
        return run(), records
    finally:
        stage.evaluate_dataset = original


def eval_breakdown(params, paths, want):
    """Per image, through the validate stage's own set-up: the host's load
    (decode, LANCZOS; one thread); the host's enqueue, the time the
    extractor call that validate makes (pad, upload, the whole chain) takes
    to return with the card idle before it (nothing inside synchronises);
    and the device's parts by CUDA events, on a copy of that chain with an
    event between the parts (upload; preprocess with K4; each scale's
    resize + VGG16 + GeM; aggregation + Lw; the gaps the host leaves are
    inside them). Both chains' descriptors must equal `want` (D, N), the
    validate run's."""
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.ops.maskprop import MaskState, mask_from_sizes
    from gandtr_tpu_torch.ops.resize import masked_scale_resize
    from gandtr_tpu_torch.scenarios import validate_stage
    setup = validate_stage.build_eval(params, torch.device("cuda"))
    ex, model = setup["extractor"], setup["model"]
    lw, ms = model.wrappers_eval          # sorted: 0_cirwhiten, 1_...
    size = params["data"]["image_size"]
    t0 = time.perf_counter()
    loaded = [R._load_preprocessed(p, size, setup["transform"])
              for p in paths]
    host_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    enqueue, direct = [], []
    for rep in range(2):                  # the first pass warms up
        for img in loaded:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = ex(img)
            t1 = time.perf_counter()
            if rep:
                enqueue.append(t1 - t0)
                direct.append(v)
    torch.cuda.synchronize()
    host = [ex._pad_and_mask(img) for img in loaded]
    names = (["upload", "preprocess"]
             + ["scale_%.4g" % s for s in ms.scales] + ["aggregate_lw"])
    marks, got = [], []
    with torch.inference_mode():
        for rep in range(2):              # the first pass warms up
            marks = []
            for padded, hw in host:
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(names) + 1)]
                ev[0].record()
                x = ex._upload(padded[None])
                sizes = ex._upload(np.asarray([hw], np.int64))
                mask = mask_from_sizes((sizes[:, 0], sizes[:, 1]),
                                       x.shape[1], x.shape[2])
                ev[1].record()
                y = setup["pre"](x, mask)
                ev[2].record()
                st = MaskState.maybe(mask, [hw])
                descs = []
                for k, s in enumerate(ms.scales):
                    xs, sts = (y, st) if s == 1 else \
                        masked_scale_resize(y, st, s)
                    descs.append(model.module(
                        xs, mask=sts.mask(xs.shape[1], xs.shape[2])))
                    ev[3 + k].record()
                v = lw.post(ms.post(descs, setup["ctx"], None),
                            setup["ctx"], None)
                ev[-1].record()
                marks.append(ev)
                if rep:
                    got.append(v[0])
        torch.cuda.synchronize()
    parts = {n: float(np.mean([ev[i].elapsed_time(ev[i + 1])
                               for ev in marks]))
             for i, n in enumerate(names)}
    d = max(float(np.abs(torch.stack(g, 1).cpu().numpy() - want).max())
            for g in (got, direct))
    return {"host_load_ms_per_image": host_ms,
            "host_enqueue_ms_per_image": 1e3 * float(np.mean(enqueue)),
            "device_ms_per_image": sum(parts.values()),
            "device_parts_ms_per_image": parts, "vs_validate_max": d}


def eval_busy_share(params, label="eval"):
    """The device's busy share over the evaluation of the dataset in one
    bucketed validate run (`evaluate_dataset`: loading, extraction, ranking
    and mAP; the stage's set-up before it is left out): the kernels' and
    copies' time on the card (torch.profiler, CUDA activity only) over that
    window's wall time; and the host's time inside the extractor calls
    there (pad, upload, the chain's launches), with the loader threads
    running beside them; and the kernels and copies on the card a photo
    (what the host issues)."""
    from torch.profiler import ProfilerActivity, profile
    from gandtr_tpu_torch.eval.retrieval import ShapeCachedExtractor
    from gandtr_tpu_torch.scenarios import validate_stage
    window, in_calls = {}, []
    original = validate_stage.evaluate_dataset
    call = ShapeCachedExtractor.__call__

    def timed_call(self, img):
        t0 = time.perf_counter()
        out = call(self, img)
        in_calls.append(time.perf_counter() - t0)
        return out

    def profiled(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = original(*args, **kwargs)
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - t0
        window["prof"] = prof
        return res

    validate_stage.evaluate_dataset = profiled
    ShapeCachedExtractor.__call__ = timed_call
    try:
        validate_stage.validate(params, None)
    finally:
        validate_stage.evaluate_dataset = original
        ShapeCachedExtractor.__call__ = call
    wall = window["wall"]
    device = [e for e in window["prof"].events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    share = busy_us / 1e6 / wall
    call_ms = 1e3 * float(np.mean(in_calls))
    print("%s bucketed, the dataset's evaluation under the profiler (set-"
          "up left out): %.3f s wall, the card busy %.3f s (%.1f%%), idle "
          "%.1f%%; the host %.2f ms a photo in the extractor's call (%d "
          "calls); %.0f kernels and copies on the card a photo"
          % (label, wall, busy_us / 1e6, 100 * share, 100 - 100 * share,
             call_ms, len(in_calls), len(device) / len(in_calls)))
    return {"wall_s": wall, "busy_s": busy_us / 1e6, "busy_share": share,
            "host_ms_in_extractor_call": call_ms,
            "device_ops_per_photo": len(device) / len(in_calls)}


def check_ranking(vecs, qvecs):
    """rank_descriptors on the card against numpy's stable argsort of the
    float64 scores: equal wherever a rank's score is more than 1e-6 from
    its neighbours'. Returns (positions compared, positions excluded, rank
    ms)."""
    from gandtr_tpu_torch.ops.ranking import (compute_map_protocols,
                                              rank_descriptors)
    V = torch.from_numpy(vecs).cuda()
    Q = torch.from_numpy(qvecs).cuda()
    ranks = rank_descriptors(V, Q).cpu().numpy()
    s64 = vecs.T.astype(np.float64) @ qvecs.astype(np.float64)
    want = np.argsort(-s64, axis=0, kind="stable")
    srt = np.take_along_axis(s64, want, axis=0)
    gap = np.abs(np.diff(srt, axis=0)) > 1e-6
    clear = np.ones(srt.shape, bool)
    clear[1:] &= gap
    clear[:-1] &= gap
    wrong = int(((ranks != want) & clear).sum())
    print("ranking on the card vs float64 numpy: %d of %d positions "
          "compared, %d excluded (a neighbour within 1e-6), %d differ"
          % (int(clear.sum()), clear.size, int((~clear).sum()), wrong))
    if wrong:
        raise AssertionError("rank_descriptors differs from numpy")
    rank_ms = cuda_ms(lambda: rank_descriptors(V, Q), reps=20)
    return int(clear.sum()), int((~clear).sum()), rank_ms


def validate_modes(dev, params_for, n_img, dim, calls, label="eval"):
    """The validate stage on the card, bucketed (`params_for(64)`: K4) and
    exact (`params_for(None)`: K1): each mode once to warm up, then once
    with every launch count set to 0 just before it and its kernel's calls
    recorded into `calls`. Checks the descriptors (finite, unit norm,
    `dim`-d) and the launches (one of the mode's kernel a photo: no loader
    section, batch 1). Returns {mode: {...}} with the recorded
    (metrics, aps, vecs, qvecs)."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.scenarios import validate_stage
    out = {}
    for bucket in (64, None):
        mode = "bucketed" if bucket else "exact"
        params = params_for(bucket)
        t0 = time.perf_counter()
        validate_stage.validate(params, None)
        cold = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernel, other = ("K4", "K1") if bucket else ("K1", "K4")
        restore = (_recording_calls(kmasked, "clahe_u8_masked_cuda",
                                    calls["K4"]) if bucket else
                   _recording_calls(kclahe, "clahe_u8_cuda", calls["K1"]))
        try:
            reset_launches()
            t0 = time.perf_counter()
            (res,), rec = _recorded(validate_stage, lambda: validate_stage
                                    .validate(params, None))
            wall = time.perf_counter() - t0
            counts = launches()
        finally:
            restore()
        # the stage's set-up alone (the net with its seeded weights drawn
        # on the host or read from its file, the Lw): the rest of the wall
        # is the extraction, ranking and mAP
        t0 = time.perf_counter()
        validate_stage.build_eval(params, dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        metrics, aps, vecs, qvecs = rec[0]
        out[mode] = {"wall_s": wall, "first_wall_s": cold,
                     "setup_s": setup, "images_per_s": n_img / wall,
                     "images_per_s_after_setup": n_img / (wall - setup),
                     "launches": counts,
                     "metadata": res["metadata"]["validation"],
                     "aps": aps, "vecs": vecs, "qvecs": qvecs}
        print("%s %s (shape_bucket %s): %.3f s for %d images, %.2f "
              "images/s (first run %.3f s); set-up %.3f s, after it "
              "%.2f images/s; launches %s; mAP %s"
              % (label, mode, bucket, wall, n_img, n_img / wall, cold, setup,
                 n_img / (wall - setup), counts,
                 json.dumps({k: v for k, v in metrics.items()})))
        for name, v in (("vecs", vecs), ("qvecs", qvecs)):
            norms = np.linalg.norm(v, axis=0)
            if not np.isfinite(v).all() or v.shape[0] != dim \
                    or np.abs(norms - 1).max() > 1e-5:
                raise AssertionError("%s %s %s: bad %s %s" % (
                    label, mode, name, v.shape, norms))
        if counts[kernel] != n_img or counts[other] != 0:
            raise AssertionError("%s %s launched %s for %d batches"
                                 % (label, mode, counts, n_img))
    return out


def compare_modes(out, n_q, label="eval"):
    """Bucketed against exact: descriptors within 1e-4, equal APs for the
    queries whose ranks agree, equal mAPs where all do. Returns the
    descriptors' largest difference."""
    from gandtr_tpu_torch.ops.ranking import rank_descriptors
    b, e = out["bucketed"], out["exact"]
    d_be = float(max(np.abs(b["vecs"] - e["vecs"]).max(),
                     np.abs(b["qvecs"] - e["qvecs"]).max()))
    rb, re_ = (rank_descriptors(o["vecs"], o["qvecs"]).cpu().numpy()
               for o in (b, e))
    same_q = [q for q in range(n_q)
              if np.array_equal(rb[:, q], re_[:, q])]
    ap_diff = max([abs(b["aps"][k][q] - e["aps"][k][q])
                   for k in b["aps"] for q in same_q] or [0.0])
    print("%s bucketed vs exact: descriptors max |diff| %.3g; ranks equal "
          "for %d of %d queries, their APs max |diff| %.3g; metadata %s vs "
          "%s" % (label, d_be, len(same_q), n_q, ap_diff,
                  json.dumps(b["metadata"]), json.dumps(e["metadata"])))
    if d_be > 1e-4 or ap_diff:
        raise AssertionError("%s: bucketed and exact disagree" % label)
    if len(same_q) == n_q and any(
            b["metadata"][k] != e["metadata"][k]
            for k in b["metadata"] if "score_avg" in k):
        raise AssertionError("%s: equal ranks, different mAPs" % label)
    return d_be


def run_eval(dev):
    """The validate stage of eval.yml on the card, bucketed (K4) and exact
    (K1): each mode runs once to warm up, then once with every launch count
    set to 0 just before it. Checks the descriptors, the launches, the mAPs,
    the ranking, and two images against the port on the CPU."""
    import pickle
    import shutil
    import tempfile
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.ops.ranking import (compute_map_protocols,
                                              rank_descriptors)
    from gandtr_tpu_torch.scenarios import validate_stage
    calls = {"K4": [], "K1": []}
    root = tempfile.mkdtemp(prefix="eval_set_")
    try:
        t0 = time.perf_counter()
        db_paths = make_eval_set(root)
        lw_path = os.path.join(root, "lw.pkl")
        with open(lw_path, "wb") as f:
            pickle.dump(seeded_lw(), f)
        print("eval set: %d database photos, %d queries, written in %.1f s"
              % (EVAL_DB, EVAL_Q, time.perf_counter() - t0))
        out = validate_modes(
            dev, lambda bucket: eval_params(root, lw_path, bucket),
            EVAL_DB + EVAL_Q, 512, calls)
        geo = check_clahe_at_eval(calls)
        busy = eval_busy_share(eval_params(root, lw_path, 64))
        d_be = compare_modes(out, EVAL_Q)
        b = out["bucketed"]
        compared, excluded, rank_ms = check_ranking(
            b["vecs"], np.concatenate([b["qvecs"], b["vecs"]], axis=1))
        ranks = rank_descriptors(b["vecs"], b["qvecs"]).cpu().numpy()
        cfg = R.configdataset("roxford5k", root)
        t0 = time.perf_counter()
        for _ in range(20):
            compute_map_protocols("roxford5k", ranks, cfg["gnd"])
        map_ms = 1e3 * (time.perf_counter() - t0) / 20

        # two database images through the port on the CPU
        torch.set_num_threads(os.cpu_count() or 1)
        cpu = validate_stage.build_eval(eval_params(root, lw_path, 64),
                                        torch.device("cpu"))
        t0 = time.perf_counter()
        cpu_vecs = R.extract_vectors(cpu["extractor"], db_paths[:2], 1024,
                                     cpu["transform"])
        cpu_s = time.perf_counter() - t0
        d_cpu = float(np.abs(cpu_vecs - b["vecs"][:, :2]).max())
        print("eval card vs CPU port on 2 database images: max |diff| %.3g "
              "(CPU took %.1f s)" % (d_cpu, cpu_s))
        if d_cpu > 1e-4:
            raise AssertionError("eval card vs CPU port: %g" % d_cpu)

        bd = eval_breakdown(eval_params(root, lw_path, 64), db_paths,
                            b["vecs"])
        print("eval breakdown (bucketed, per database image): host load "
              "%.2f ms, host enqueue %.2f ms, against device %.2f ms: %s; "
              "ranking %.4f ms (%d x %d), mAP %.3f ms (host)"
              % (bd["host_load_ms_per_image"],
                 bd["host_enqueue_ms_per_image"], bd["device_ms_per_image"],
                 json.dumps(bd["device_parts_ms_per_image"]), rank_ms,
                 EVAL_DB, EVAL_Q + EVAL_DB, map_ms))
        if bd["vs_validate_max"] > 1e-5:
            raise AssertionError("the breakdown's chain differs from "
                                 "validate's: %g" % bd["vs_validate_max"])
        return {"launches": {m: out[m]["launches"] for m in out},
                "images_per_s": {m: out[m]["images_per_s"] for m in out},
                "images_per_s_after_setup": {
                    m: out[m]["images_per_s_after_setup"] for m in out},
                "setup_s": {m: out[m]["setup_s"] for m in out},
                "bucketed_device_busy": busy,
                "bucketed_vs_exact": d_be, "card_vs_cpu": d_cpu,
                "ranks_compared": compared, "ranks_excluded": excluded,
                "rank_ms": rank_ms, "map_ms": map_ms, "breakdown": bd,
                "at_eval_geometry": geo}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the ResNet-101 chain of finetune_r101 and eval_r101

def r101_eval_params(root, ckpt, lw_path, shape_bucket):
    """eval.yml with finetune_r101's step 4 overrides (eval_r101's, with a
    network file and an Lw): the ResNet-101 embed from step 1's file, step
    2's Lw, the synthetic set and `shape_bucket`."""
    params = eval_params(root, lw_path, shape_bucket)
    params["network"]["path"] = ckpt
    params["network"]["model"]["cir_architecture"] = "resnet101"
    return params


def make_whiten_set(root, images, db):
    """The tuple set's photos as a retrieval-SfM-style whitening set: each
    under a cid of 40 hex characters in the reference's tree root/ims/
    cid[-2:]/cid[-4:-2]/cid[-6:-4]/cid, and a pickle {"cids", "qidxs",
    "pidxs"} named as the published one (so the stage writes
    lw-retrieval.pkl), with the tuple set's query / positive pairs (one a
    cluster). Returns the pickle's path."""
    import hashlib
    import pickle
    import shutil
    cids = []
    for path in images:
        cid = hashlib.sha1(os.path.basename(path).encode()).hexdigest()
        sub = os.path.join(root, "ims", cid[-2:], cid[-4:-2], cid[-6:-4])
        os.makedirs(sub, exist_ok=True)
        shutil.copyfile(path, os.path.join(sub, cid))
        cids.append(cid)
    out = os.path.join(root, "retrieval-SfM-120k-whiten.pkl")
    with open(out, "wb") as f:
        pickle.dump({"cids": cids, "qidxs": list(db["qidxs"]),
                     "pidxs": list(db["pidxs"])}, f)
    return out


def r101_hub(calls):
    """(a) hub.gem_resnet101_cyclegan (seeded, a seeded 2048x2048 Lw) served
    by serve_http: rounds of 8 concurrent 768x1024 npy requests, every
    launch count set to 0 just before them, K1's calls recorded."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.serving.export import Servable
    from gandtr_tpu_torch.serving.service import serve_http
    lw = seeded_lw(2048)
    model = hub.gem_resnet101_cyclegan(pretrained=False, whitening=lw)
    images = np.random.RandomState(2).randint(
        0, 256, (N_REQ,) + HW + (3,), dtype=np.uint8)
    servable = Servable(model, HW)
    server = serve_http({"gem_r101": servable}, port=0, block=False,
                        max_wait_ms=1000.0)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        batches0 = server.models["gem_r101"].batcher.batches
        restore = _recording_calls(kclahe, "clahe_u8_cuda", calls["K1"])
        try:
            reset_launches()
            answers, timing = serve_rounds(base, "gem_r101", images)
            counts = launches()
        finally:
            restore()
        batches = server.models["gem_r101"].batcher.batches - batches0
        t0 = time.perf_counter()
        direct = servable(images)
        timing["direct_servable_ms"] = 1e3 * (time.perf_counter() - t0)
    finally:
        server.close()
    served = np.asarray([json.loads(body)["descriptor"]
                         for _, body in answers], np.float32)
    norms = np.linalg.norm(served, axis=1)
    if not np.isfinite(served).all() or served.shape != (N_REQ, 2048) \
            or np.abs(norms - 1).max() > 1e-5:
        raise AssertionError("r101 hub: bad descriptors %s %s"
                             % (served.shape, norms))
    d_direct = float(np.abs(served - direct).max())
    if d_direct > 1e-5:
        raise AssertionError("r101 served vs direct: %g" % d_direct)
    if counts["K1"] != batches or batches < 1 or counts["K4"]:
        raise AssertionError("r101 hub launched %s for %d batches"
                             % (counts, batches))
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = hub.gem_resnet101_cyclegan(pretrained=False, whitening=lw,
                                     device="cpu")
    t0 = time.perf_counter()
    cpu_desc = Servable(cpu, HW)(images[:2])
    cpu_s = time.perf_counter() - t0
    d_cpu = float(np.abs(served[:2] - cpu_desc).max())
    if d_cpu > 1e-4:
        raise AssertionError("r101 hub card vs CPU port: %g" % d_cpu)
    del model, servable, server, cpu
    torch.cuda.empty_cache()
    return {"launches": counts, "batches": batches, **timing,
            "served_vs_direct": d_direct, "card_vs_cpu_2_images": d_cpu,
            "cpu_s": cpu_s}


def r101_finetune(dev, tmp, calls):
    """(b) finetune_r101's step 1: the loop of finetune.yml with a
    ResNet-101 embed and margin 0.85 (`finetune_r101_config`) through
    build_finetune_experiment and training.run on the seeded tuple set,
    every launch count set to 0 just before the run, K4's calls recorded;
    then the bare step on `finetune_batch`. Returns (result, the
    experiment's directory, the tuple set's images and db)."""
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.scenarios.finetune_build import (
        EXTRACT_BATCH, build_finetune_experiment)
    t0 = time.perf_counter()
    pkl = make_tuple_set(tmp)
    cfg = finetune_r101_config(pkl, os.path.join(tmp, "ims"))
    directory = os.path.join(tmp, "exp")
    exp = build_finetune_experiment(cfg, directory, device=dev)
    setup_s = time.perf_counter() - t0
    images = exp["dataset"].images
    rec = {"epochs": [], "losses": [], "tuples": [], "extract_calls": [],
           "loader_s": [], "marks": [],
           "copy_dir": os.path.join(tmp, "exp_after1")}
    _instrument_loop(exp, rec)
    embed = exp["models"]["embed"].module
    first = {k: v.detach().clone() for k, v in embed.named_parameters()}
    stats = {k: v.clone() for k, v in embed.named_buffers()}
    restore = _recording_calls(kmasked, "clahe_u8_masked_cuda", calls["K4"])
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = exp["training"].run(exp["state"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        restore()
    losses = [float(v) for v in rec["losses"]]
    per_epoch = len(exp["loader"])
    if len(losses) != R101_EPOCHS * per_epoch or \
            not np.all(np.isfinite(losses)):
        raise AssertionError("r101 loop losses %s" % losses)
    embed = state.models["embed"].module
    still = [k for k, p in embed.named_parameters()
             if torch.equal(p.detach(), first[k])]
    moved_stats = [k for k, v in embed.named_buffers()
                   if not torch.equal(v, stats[k])]
    if still or moved_stats:
        raise AssertionError("r101 loop: parameters that did not move %s, "
                             "BatchNorm statistics that did %s"
                             % (still[:5], moved_stats[:5]))
    batches = _extraction_batches(rec["extract_calls"], images, 0.25, "anc",
                                  EXTRACT_BATCH)
    t = cfg["data"]["train"]["loader"]["batch_size"]
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": batches + t * len(losses)}
    if counts != want:
        raise AssertionError("r101 loop launches %s, expected %s (%d "
                             "extraction batches, %d steps of %d tuples)"
                             % (counts, want, batches, len(losses), t))
    prof = rec.pop("prof")
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    ep2 = rec["epochs"][-1]
    loop_step_ms = 1e3 * (ep2["run_s"] - ep2["mining_s"]) / per_epoch
    ckpt = os.path.join(directory, "epochs", "embed_best.ckpt")
    if not os.path.exists(ckpt):
        raise AssertionError("r101 loop wrote no %s" % ckpt)

    # the bare step on the step phase's batch, after the loop
    batch = finetune_batch(dev)
    for _ in range(FT_WARMUP):
        state, m = exp["step"](state, *batch)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(FT_STEPS):
        state, m = exp["step"](state, *batch)
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t0) / FT_STEPS
    step_counts = launches()
    if step_counts["K4"] != FT_T * FT_STEPS or step_counts["K2"] or \
            not np.isfinite(float(m["total"])):
        raise AssertionError("r101 bare step: launches %s, loss %s"
                             % (step_counts, m["total"]))
    out = {"setup_s": setup_s, "run_s": wall, "losses": losses,
           "launches": counts, "extraction_batches": batches,
           "tuples": t * len(losses),
           "k4_per_tuple_and_extraction_batch": 1,
           "epochs": [{"mining_s": e["mining_s"],
                       "steps_s": e["run_s"] - e["mining_s"],
                       "checkpoint_s": e["checkpoint_s"],
                       "events_s": e["events_s"]} for e in rec["epochs"]],
           "loop_ms_per_step_last_epoch": loop_step_ms,
           "bare_step_ms": bare_ms, "bare_step_launches": step_counts,
           "last_epoch_steps_busy_share": busy_us / 1e6 / rec["prof_wall"],
           "loader_host_ms_per_step": 1e3 * sum(rec["loader_s"])
           / len(losses),
           "params_moved": len(first), "bn_statistics_bit_equal": len(stats),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    db = exp["dataset"].db
    del exp, state, embed
    torch.cuda.empty_cache()
    return out, directory, images, db


def r101_whitening(tmp, directory, images, db, calls):
    """(c) finetune_r101's step 2: infer_and_learn_whitening by
    whitening.yml from step 1's embed_best.ckpt on a whitening set of the
    tuple set's photos, every launch count set to 0 just before it, K4's
    calls recorded; then the skip of an existing pickle."""
    import pickle
    from gandtr_tpu_torch.eval.retrieval import ShapeCachedExtractor
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops import whiten as whiten_ops
    from gandtr_tpu_torch.scenarios.multistep_stage import \
        infer_and_learn_whitening
    wroot = os.path.join(tmp, "whiten")
    wpkl = make_whiten_set(wroot, images, db)
    params = r101_whitening_params(
        os.path.join(directory, "epochs", "embed_best.ckpt"), wpkl,
        os.path.join(wroot, "ims"), directory)
    run, learn = ShapeCachedExtractor._run, whiten_ops.whitenlearn_with_retry
    n_batches, learn_s = [0], [0.0]

    def counted_run(self, imgs):
        n_batches[0] += 1
        return run(self, imgs)

    def timed_learn(*args, **kwargs):
        t0 = time.perf_counter()
        out = learn(*args, **kwargs)
        learn_s[0] += time.perf_counter() - t0
        return out

    ShapeCachedExtractor._run = counted_run
    whiten_ops.whitenlearn_with_retry = timed_learn
    restore = _recording_calls(kmasked, "clahe_u8_masked_cuda", calls["K4"])
    try:
        reset_launches()
        t0 = time.perf_counter()
        (meta,) = infer_and_learn_whitening(params, None)
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        restore()
        ShapeCachedExtractor._run = run
        whiten_ops.whitenlearn_with_retry = learn
    path = os.path.join(directory, "whitening", "lw-retrieval.pkl")
    with open(path, "rb") as f:
        lw = pickle.load(f)
    if meta["whitening_path"] != path or lw["P"].shape != (2048, 2048) \
            or lw["m"].shape != (2048, 1) or not np.isfinite(lw["P"]).all():
        raise AssertionError("r101 whitening: %s, P %s" % (
            meta["whitening_path"], lw["P"].shape))
    if counts != {"K1": 0, "K2": 0, "K3": 0, "K4": n_batches[0]}:
        raise AssertionError("r101 whitening launched %s for %d batches"
                             % (counts, n_batches[0]))
    (again,) = infer_and_learn_whitening(params, None)
    if again.get("status") != "skipped":
        raise AssertionError("r101 whitening: an existing pickle was not "
                             "skipped: %s" % again)
    n = len(images)
    return {"wall_s": wall, "lw_learning_s": learn_s[0], "images": n,
            "extraction_images_per_s": n / (wall - learn_s[0]),
            "batches": n_batches[0], "launches": counts,
            "pairs": len(db["qidxs"]), "P_shape": list(lw["P"].shape)}, path


def r101_eval(dev, tmp, ckpt, lw_path, calls):
    """(d) finetune_r101's step 4: validate by eval.yml with a ResNet-101
    from step 1's file and step 2's Lw, bucketed (K4) and exact (K1), on
    the synthetic eval set; the ranking against float64 numpy and two
    database photos against the port on the CPU."""
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.scenarios import validate_stage
    root = os.path.join(tmp, "eval")
    db_paths = make_eval_set(root)

    def params_for(bucket):
        return r101_eval_params(root, ckpt, lw_path, bucket)

    out = validate_modes(dev, params_for, EVAL_DB + EVAL_Q, 2048, calls,
                         label="eval_r101")
    busy = eval_busy_share(params_for(64), label="eval_r101")
    d_be = compare_modes(out, EVAL_Q, label="eval_r101")
    b = out["bucketed"]
    compared, excluded, rank_ms = check_ranking(
        b["vecs"], np.concatenate([b["qvecs"], b["vecs"]], axis=1))
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = validate_stage.build_eval(params_for(64), torch.device("cpu"))
    t0 = time.perf_counter()
    cpu_vecs = R.extract_vectors(cpu["extractor"], db_paths[:2], 1024,
                                 cpu["transform"])
    cpu_s = time.perf_counter() - t0
    d_cpu = float(np.abs(cpu_vecs - b["vecs"][:, :2]).max())
    if d_cpu > 1e-4:
        raise AssertionError("eval_r101 card vs CPU port: %g" % d_cpu)
    return {"launches": {m: out[m]["launches"] for m in out},
            "images_per_s": {m: out[m]["images_per_s"] for m in out},
            "images_per_s_after_setup": {
                m: out[m]["images_per_s_after_setup"] for m in out},
            "setup_s": {m: out[m]["setup_s"] for m in out},
            "metadata": b["metadata"], "bucketed_device_busy": busy,
            "bucketed_vs_exact": d_be, "card_vs_cpu_2_images": d_cpu,
            "cpu_s": cpu_s, "ranks_compared": compared,
            "ranks_excluded": excluded, "rank_ms": rank_ms}


def _clahe_summary(cases):
    """One line's worth of check_clahe_at_eval's cases of a kernel."""
    calls = sum(c["calls"] for c in cases)
    return {"cases": len(cases), "calls": calls,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms_min": min(c["ms"] for c in cases),
            "ms_max": max(c["ms"] for c in cases),
            "ms_call_weighted": sum(c["ms"] * c["calls"]
                                    for c in cases) / calls,
            "plain_ms_call_weighted": sum(c["plain_ms"] * c["calls"]
                                          for c in cases) / calls,
            "bound_ms_call_weighted": sum(c["bound_ms"] * c["calls"]
                                          for c in cases) / calls}


def run_r101(dev):
    """The ResNet-101 chain on the card, at full width and depth (2048-d,
    a 2048x2048 Lw), seeded weights: (a) the hub served, (b) finetune_r101's
    step 1, (c) its step 2 from step 1's file, (d) its step 4 (eval_r101
    with a network file and an Lw), (e) K1 and K4 held bit for bit against
    their plain versions on the very inputs (a) to (d) gave them. Each part
    counts its launches from 0; their sum is the r101 path's."""
    import shutil
    import tempfile
    calls = {"K4": [], "K1": []}
    tmp = tempfile.mkdtemp(prefix="r101_", dir=os.environ.get("TMPDIR"))
    try:
        hub_out = r101_hub(calls)
        print("r101 (a) hub gem_resnet101_cyclegan served (%d concurrent "
              "%dx%d, seeded weights, 2048x2048 Lw): %s"
              % (N_REQ, HW[0], HW[1], json.dumps(hub_out)))
        torch.cuda.reset_peak_memory_stats()
        ft, directory, images, db = r101_finetune(dev, tmp, calls)
        print("r101 (b) finetune_r101 step 1 (finetune.yml loop, resnet101 "
              "embed, margin 0.85, %d epochs, bf16 policy): %s"
              % (R101_EPOCHS, json.dumps(ft)))
        wh, lw_path = r101_whitening(tmp, directory, images, db, calls)
        print("r101 (c) finetune_r101 step 2 (infer_and_learn_whitening by "
              "whitening.yml from embed_best.ckpt): %s" % json.dumps(wh))
        ev = r101_eval(dev, tmp, os.path.join(directory, "epochs",
                                              "embed_best.ckpt"),
                       lw_path, calls)
        print("r101 (d) finetune_r101 step 4 (validate by eval.yml, "
              "resnet101 from embed_best.ckpt, the step 2 Lw): %s"
              % json.dumps(ev))
        geo = check_clahe_at_eval(calls, verbose=False)
        summary = {k: _clahe_summary(geo[k]) for k in geo}
        print("r101 (e) K1 and K4 on the inputs (a) to (d) gave them: all "
              "bit-equal to their plain versions, one kernel a call: %s"
              % json.dumps(summary))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parts = [hub_out["launches"], ft["launches"], wh["launches"]] + list(
        ev["launches"].values())
    launches_r101 = {k: sum(p[k] for p in parts)
                     for k in ("K1", "K2", "K3", "K4")}
    return {"launches": launches_r101, "hub": hub_out, "finetune": ft,
            "whitening": wh, "eval": ev, "at_r101_inputs": summary}


# ---- HED^N-GAN training: train_hedngan.yml through the train stage

MEANSTD_HED = [[0.40787054, 0.45752458, 0.48109378], [1.0, 1.0, 1.0]]
HED_WRAPPERS = ("rgb2bgr_pre,meanstd_pre:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:"
                "[[0.40787054,0.45752458,0.48109378],[1.0,1.0,1.0]]")
HED_URL = ("http://ptak.felk.cvut.cz/personal/jenicto2/download/iccv23_gan/"
           "hed_sniklaus_github.pth")
GEN_DATA = {"transforms": "pil2np | totensor | normalize",
            "mean_std": MEANSTD_GEN}


def _hed_member(frozen):
    runtime = {"wrappers": HED_WRAPPERS, "data": dict(GEN_DATA)}
    if frozen:
        runtime = {"frozen": True, **runtime}
    return {"type": "SingleNetwork",
            "model": {"architecture": "hed_interpolation",
                      "pretrained": HED_URL},
            "initialize": False, "runtime": runtime}


def _adam(lr, beta1, weight_decay):
    return {"algorithm": "adam", "lr": lr, "beta1": beta1, "beta2": 0.999,
            "weight_decay": weight_decay}


# parameters/train_hedngan.yml as shipped, its validation template
# (_gan_eval.yml) expanded (tests/test_torch_gan_train.py holds it equal)
GAN_TRAIN = {
    "network": {
        "type": "NetworkSet",
        "generator_X": {
            "type": "SingleNetwork",
            "model": {"architecture": "official_resnet_generator",
                      "no_antialias": True, "no_antialias_up": True,
                      "input_nc": 3, "output_nc": 3, "n_blocks": 9,
                      "norm_layer": "batch"},
            "initialize": {"weights": "kaiming_p2p", "seed": 0},
            "runtime": {"wrappers": "", "data": dict(GEN_DATA)}},
        "detector": _hed_member(False),
        "detector_frozen": _hed_member(True),
        "discriminator_Y": {
            "type": "SingleNetwork",
            "model": {"architecture": "official_p2p_discriminator",
                      "no_antialias": True, "input_nc": 3,
                      "norm_layer": "batch"},
            "initialize": {"weights": "kaiming_p2p", "seed": 0},
            "runtime": {"wrappers": "", "data": {}}}},
    "learning": {
        "type": "TrainValLearning",
        "checkpoints": {"directory": "experiments/gan/${SCENARIO_NAME}",
                        "store_every": 10, "checkpoint_every": 2,
                        "directory_epoch_regex": None},
        "training": {
            "type": "EpochTraining", "epochs": 50, "seed": 0,
            "dispatch_chunk": 8, "deterministic": False,
            "criterion": {
                "loss": "multihead_loss",
                "weights": {"adversarial": 1, "edge": 5, "hed": 1},
                "normalize_weights": False,
                "adversarial": {"loss": "discriminator_loss",
                                "criterion": {"loss": "mse"}},
                "edge": {"loss": "l1"}, "hed": {"loss": "l1"}},
            "optimizer": {"generator_X": _adam(2e-4, 0.5, 0),
                          "discriminator_Y": _adam(2e-4, 0.5, 0),
                          "detector": _adam(1e-6, 0.9, 0.0002)},
            "scheduler": {name: {"algorithm": "lambda_p2p",
                                 "n_epochs_decay": 25}
                          for name in ("generator_X", "discriminator_Y",
                                       "detector")},
            "epoch_iteration": {"type": "SupervisedHEDNGANEpoch",
                                "data": "train", "criterion": "default"}},
        "validation": {
            "type": "MultiCriterialValidation",
            "decisive_criterion": "epoch",
            "visual": {
                "type": "SingleValidation", "frequency": 5,
                "network_overlay": None, "data": None,
                "criterion": {"type": "visual", "data": {
                    "dataset": {"name": "InferImageList",
                                "image_dir": "data/val/day_night"},
                    "transforms": "pil2np | downscale:362 | totensor | "
                                  "normalize",
                    "mean_std": MEANSTD_GEN}}}}},
    "output": {"learning": {"progress": {"print_each": 100,
                                         "print_each_val": 1000},
                            "htmlreport": {}}},
    "data": {"train": {
        "dataset": {"name": "RandomDomainsPair",
                    "dataset_X": "data/train/retrieval-SfM-120k/dataset/"
                                 "train_day.txt",
                    "dataset_Y": "data/train/retrieval-SfM-120k/dataset/"
                                 "train_night.txt",
                    "image_dir": "data/train/retrieval-SfM-120k/ims/*",
                    "size": 10000},
        "loader": {"batch_size": 10},
        "transforms": "pil2np | scalecrop:256_256:0.8_1 | totensor | "
                      "normalize",
        "mean_std": MEANSTD_GEN}},
}
# the cuts of scale (PERF.md §4 "GAN training")
GAN_CUTS = {"size": 40, "epochs": 2, "n_epochs_decay": 1,
            "checkpoint_every": 1, "store_every": 2, "frequency": 1}
GAN_DOMAIN = 30          # seeded JPEGs a domain, longest side 362
GAN_SHAPES = [(272, 362), (362, 272), (362, 362), (300, 362), (362, 300),
              (256, 362)]
GAN_VAL_SHAPES = [(480, 640), (640, 480), (600, 800), (362, 362)]


def _photo(rs, h, w, dark=False):
    """A seeded photo of smooth noise (so edge maps are not flat), darkened
    for the night domain."""
    from PIL import Image
    small = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    arr = np.asarray(img).astype(np.float32)
    arr += rs.randint(-20, 21, arr.shape)
    if dark:
        arr *= 0.35
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def make_domain_set(root, seed=0):
    """GAN_DOMAIN seeded JPEGs a domain (smooth noise, so the edge maps
    are not flat) in <root>/ims with their list files, and 4 validation
    photos in <root>/val. Returns the two list paths."""
    rs = np.random.RandomState(seed)
    ims, val = os.path.join(root, "ims"), os.path.join(root, "val")
    os.makedirs(ims)
    os.makedirs(val)
    lists = []
    for d, dark in (("day", False), ("night", True)):
        names = []
        for i in range(GAN_DOMAIN):
            h, w = GAN_SHAPES[i % len(GAN_SHAPES)]
            names.append("%s_%02d.jpg" % (d, i))
            _photo(rs, h, w, dark).save(os.path.join(ims, names[-1]),
                                        quality=90)
        lists.append(os.path.join(root, "train_%s.txt" % d))
        with open(lists[-1], "w") as f:
            f.write("\n".join(names) + "\n")
    for i, (h, w) in enumerate(GAN_VAL_SHAPES):
        _photo(rs, h, w).save(os.path.join(val, "val_%d.jpg" % i))
    return lists


def gan_train_config(root, lists):
    """GAN_TRAIN with the cuts of GAN_CUTS on the set of make_domain_set,
    the HED files `pretrained: null` (seeded weights) and the experiment
    under <root>/exp."""
    import copy
    cfg = copy.deepcopy(GAN_TRAIN)
    for k in ("detector", "detector_frozen"):
        cfg["network"][k]["model"]["pretrained"] = None
    lt = cfg["learning"]["training"]
    lt["epochs"] = GAN_CUTS["epochs"]
    for sched in lt["scheduler"].values():
        sched["n_epochs_decay"] = GAN_CUTS["n_epochs_decay"]
    cfg["learning"]["checkpoints"].update(
        directory=os.path.join(root, "exp"),
        checkpoint_every=GAN_CUTS["checkpoint_every"],
        store_every=GAN_CUTS["store_every"])
    vis = cfg["learning"]["validation"]["visual"]
    vis["frequency"] = GAN_CUTS["frequency"]
    vis["criterion"]["data"]["dataset"]["image_dir"] = os.path.join(root,
                                                                    "val")
    cfg["data"]["train"]["dataset"].update(
        dataset_X=lists[0], dataset_Y=lists[1],
        image_dir=os.path.join(root, "ims") + "/*", size=GAN_CUTS["size"])
    return cfg


def _instrument_gan(exp, rec):
    """Time the loop's parts on their instances (per epoch: the steps, the
    checkpoint save, the events and report, the validation), record every
    step's metrics, profile epoch 2's steps (rec["profile_epoch"]'s where
    given) with torch.profiler, and copy the directory after epoch 1."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    training, loop = exp["training"], exp["training"].loop
    orig = {"run": loop.run_epoch, "save": exp["checkpoints"].save_epoch,
            "norms": training._log_weight_norms,
            "sample": training._log_traindata_sample,
            "close": exp["events"].close_epoch, "step": loop.step_fn}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["epochs"][-1][key] += time.perf_counter() - t0
            return out
        return wrapper

    def run_epoch(state, epoch):
        rec["epochs"].append(dict.fromkeys(
            ("steps_s", "checkpoint_s", "events_s", "validation_s"), 0.0))
        profiled = epoch == rec.get("profile_epoch", 2)
        if profiled:
            rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
            rec["prof"].__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = orig["run"](state, epoch)
        torch.cuda.synchronize()
        rec["epochs"][-1]["steps_s"] = time.perf_counter() - t0
        if profiled:
            rec["prof_wall"] = rec["epochs"][-1]["steps_s"]
            rec["prof"].__exit__(None, None, None)
        return state

    def step_fn(state, *args):
        out = orig["step"](state, *args)
        rec["metrics"].append(out[1])
        return out

    def hook(state, epoch):
        if epoch == 1:
            shutil.copytree(exp["checkpoints"].directory, rec["copy_dir"],
                            symlinks=True)

    loop.run_epoch = run_epoch
    loop.step_fn = step_fn
    exp["checkpoints"].save_epoch = timed("checkpoint_s", orig["save"])
    training._log_weight_norms = timed("events_s", orig["norms"])
    training._log_traindata_sample = timed("events_s", orig["sample"])
    exp["events"].close_epoch = timed("events_s", orig["close"])
    training.validations = [timed("validation_s", v)
                            for v in training.validations]
    training.state_hook = hook


def gan_step_breakdown(exp, X, Y, reps=3):
    """CUDA-event spans of the real step's parts, marked where it calls
    them: the generator forward (its first `apply`), the D step (forwards,
    loss, backward), D's Adam, the E step (teacher, student forwards,
    backward), the student's Adam, the G step (D and student forwards on
    fake_Y, loss, backward through them and G), G's Adam, and the rest
    (the student on one image for the blobs). Medians over `reps` steps."""
    G = exp["models"]["generator_X"]
    opts = exp["optimizers"]
    names = ["g_forward", "d_step", "d_adam", "e_step", "e_adam", "g_step",
             "g_adam", "rest"]
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    g_apply = G.apply

    def apply(*a, **k):
        out = g_apply(*a, **k)
        if len(marks) == 1:
            mark()
        return out
    saved = {name: opt.step for name, opt in opts.items()}

    def wrap(fn):
        def step(*a, **k):
            mark()
            out = fn(*a, **k)
            mark()
            return out
        return step
    spans = []
    try:
        G.apply = apply
        for name in ("discriminator_Y", "detector", "generator_X"):
            opts[name].step = wrap(saved[name])
        for _ in range(reps + 1):
            marks.clear()
            mark()
            exp["step"](exp["state"], X, Y)
            mark()
            torch.cuda.synchronize()
            spans.append([a.elapsed_time(b)
                          for a, b in zip(marks[:-1], marks[1:])])
    finally:
        del G.apply
        for name, fn in saved.items():
            del opts[name].step
    med = np.median(np.asarray(spans[1:]), axis=0)
    out = dict(zip(names, (float(v) for v in med)))
    out["total"] = float(sum(med))
    return out


def _g_grad_terms(exp, x):
    """The generator's gradient of each G-step term apart, on the starting
    weights, before the step: the adversarial mse through D (train mode)
    and the edge L1 through the student against sigmoid(teacher); and the
    L1's sign map. G's and D's statistics are put back after."""
    from gandtr_tpu_torch.ops import losses as L
    G, D = exp["models"]["generator_X"], exp["models"]["discriminator_Y"]
    H_s, H_t = exp["models"]["detector"], exp["models"]["detector_frozen"]
    saved = [(net, {k: v.clone() for k, v in net.module.state_dict().items()})
             for net in (G, D)]
    params = list(G.module.parameters())
    fake = G.apply(x, train=True)
    with torch.no_grad():
        real_E = torch.sigmoid(H_t.apply(x, no_sigmoid=True))
    adv = L.discriminator_loss(D.apply(fake, train=True), True, L.mse_loss)[0]
    fake_E = H_s.apply(fake)
    edge = 5 * L.l1_loss(fake_E, real_E)
    flat = [torch.cat([g.flatten() for g in torch.autograd.grad(
        loss, params, retain_graph=True)]).cpu() for loss in (adv, edge)]
    for net, state in saved:
        net.module.load_state_dict(state)
    return flat[0], flat[1], torch.sign(fake_E - real_E).detach().cpu()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


GAN_OPTIMIZED = ("generator_X", "discriminator_Y", "detector")


def _grab_grads(exp, names):
    """Wrap each named network's optimizer step so that it first copies the
    network's gradients to the host. Returns {name: {parameter: grad}},
    filled by the next step."""
    grads = {}
    for name in names:
        opt, module = exp["optimizers"][name], exp["models"][name].module
        grads[name] = {}

        def step(*a, _adam=opt.step, _module=module, _into=grads[name],
                 **k):
            _into.update({n: p.grad.detach().cpu().clone()
                          for n, p in _module.named_parameters()})
            return _adam(*a, **k)
        opt.step = step
    return grads


def _flat(grads):
    return torch.cat([grads[k].flatten() for k in sorted(grads)])


def _gan_parity(dev, lists, root):
    """One step at batch 2 and 128x128, full width, from the same seeded
    weights on the card and in the port on the CPU: the losses within
    1e-3 relative and fake_Y within 1e-4. The gradients against the same
    ones in float64 on the CPU, the card's within twice the CPU float32's
    distance from them: D's and the student's, each taken just before its
    Adam update in the step (they depend on the starting weights only),
    and the generator's two G-step terms apart, on the starting weights
    (the step's own G gradient goes through the updated D and student).
    The L1 terms are ill-conditioned: float32 itself lands about 3e-3 of
    their norm away. As a sanity check only, every updated generator
    parameter within 2 lr of the CPU's (Adam's first step is lr times
    g/(|g| + eps), below lr for any g). Printed beside them: the step's
    whole G gradient card vs CPU, the count of its elements of the other
    sign, and the updated generator's output difference on the batch's
    statistics and in eval mode."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = gan_train_config(root, lists)
    rs = np.random.RandomState(7)
    X, Y = (rs.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
            for _ in range(2))
    torch.set_num_threads(os.cpu_count() or 1)
    ref = build_gan_experiment(cfg, device="cpu")
    for net in ref["models"].values():
        net.module.double()
    x64, y64 = torch.from_numpy(X).double(), torch.from_numpy(Y).double()
    terms = _g_grad_terms(ref, x64)
    grads = _grab_grads(ref, GAN_OPTIMIZED[1:])
    ref["step"](ref["state"], x64, y64)
    ref = {"G_adv": terms[0], "G_edge": terms[1],
           "D": _flat(grads["discriminator_Y"]).double(),
           "E": _flat(grads["detector"]).double()}
    del grads, terms
    out = {}
    for where in ("cpu", dev):
        exp = build_gan_experiment(cfg, device=where)
        x, y = torch.from_numpy(X).to(where), torch.from_numpy(Y).to(where)
        terms = _g_grad_terms(exp, x)
        G = exp["models"]["generator_X"].module
        grads = _grab_grads(exp, GAN_OPTIMIZED)
        t0 = time.perf_counter()
        _, m, dbg = exp["step"](exp["state"], x, y)
        s = time.perf_counter() - t0
        with torch.no_grad():
            g_eval = G.eval()(x).cpu()
            g = G.train()(x).cpu()
        out[str(where)] = {"metrics": {k: float(v) for k, v in m.items()},
                           "fake_Y": dbg["fake_Y"].cpu(), "G": g,
                           "G_eval": g_eval, "s": s,
                           "params": {k: v.detach().cpu() for k, v in
                                      G.named_parameters()},
                           "grads": grads["generator_X"],
                           "vs64": {"G_adv": terms[0], "G_edge": terms[1],
                                    "D": _flat(grads["discriminator_Y"]),
                                    "E": _flat(grads["detector"])},
                           "signs": terms[2]}
        out[str(where)]["vs64"] = {k: _rel(v.double(), ref[k]) for k, v
                                   in out[str(where)]["vs64"].items()}
        del exp
    cpu, card = out["cpu"], out[str(dev)]
    rel = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-12)
           for k, v in cpu["metrics"].items()}
    d_fake = float((card["fake_Y"] - cpu["fake_Y"]).abs().max())
    gc, gg = _flat(cpu["grads"]), _flat(card["grads"])
    d_params = max(float((card["params"][k] - v).abs().max())
                   for k, v in cpu["params"].items())
    lr = cfg["learning"]["training"]["optimizer"]["generator_X"]["lr"]
    res = {"loss_rel_max": max(rel.values()), "loss_rel": rel,
           "fake_Y_max": d_fake,
           "grad_rel_to_float64_cpu": cpu["vs64"],
           "grad_rel_to_float64_card": card["vs64"],
           "edge_l1_signs_differing": int(
               (card["signs"] != cpu["signs"]).sum()),
           "G_grad_rel": _rel(gg, gc),
           "G_grad_sign_flips": int(((gg > 0) != (gc > 0)).sum()),
           "G_grad_elements": int(gc.numel()),
           "updated_G_params_max": d_params,
           "updated_G_max": float((card["G"] - cpu["G"]).abs().max()),
           "updated_G_eval_mode_max": float(
               (card["G_eval"] - cpu["G_eval"]).abs().max()),
           "cpu_step_s": cpu["s"], "E_real_cpu": cpu["metrics"]["E_real"],
           "E_real_card": card["metrics"]["E_real"]}
    if max(rel.values()) > 1e-3 or d_fake > 1e-4 \
            or d_params > 2 * lr * (1 + 1e-6) \
            or any(v > 2 * cpu["vs64"][k] for k, v in card["vs64"].items()):
        raise AssertionError("GAN step card vs CPU: %s" % json.dumps(res))
    return res


def _gan_tie(exp, X):
    """The student on real images equals its teacher bit for bit before
    the first step (pre-sigmoid, through the same wrappers)."""
    H_s, H_t = exp["models"]["detector"], exp["models"]["detector_frozen"]
    with torch.no_grad():
        target = H_t.apply(X, no_sigmoid=True)
    real_M = H_s.apply(X, no_sigmoid=True)
    if not torch.equal(real_M.detach(), target):
        raise AssertionError("student vs teacher at start: %g" % float(
            (real_M.detach() - target).abs().max()))
    return True


def _max_adam_steps(exp, name, epochs):
    """{parameter name: the largest lr its group had over the run}:
    base_lr x the group's lr_mult x the schedule's largest factor over the
    epochs. Adam's first step of each element is lr times the gradient's
    sign, and the later ones are of that size."""
    opt = exp["optimizers"].get(name)
    if opt is None:
        return {}
    sched = exp["schedules"].get(name)
    factor = max(sched(e) for e in range(epochs)) if sched else 1.0
    base = exp["base_lr"][name]
    by_id = {id(p): k for k, p in exp["models"][name].module
             .named_parameters()}
    return {by_id[id(p)]: base * g.get("lr_mult", 1.0) * factor
            for g in opt.param_groups for p in g["params"]}


def _below_half_ulp(p, step):
    v = p.detach().abs().cpu().numpy().astype(np.float32)
    return bool((np.spacing(v) / 2 > step).all())


def _bn_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def run_gan_train(dev):
    """train_hedngan.yml (GAN_TRAIN, full width, seeded weights, cut by
    GAN_CUTS) through the port's train stage set-up on the card: two
    epochs of 4 steps at batch 10 on 256x256 crops of a seeded domain set,
    every launch count set to 0 just before `training.run` and read just
    after; then the checks, the resume, the hub, the CPU parity and the
    timings."""
    import shutil
    import tempfile
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    tmp = tempfile.mkdtemp(prefix="gan_", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        lists = make_domain_set(tmp)
        cfg = gan_train_config(tmp, lists)
        directory = cfg["learning"]["checkpoints"]["directory"]
        exp = build_gan_experiment(cfg, directory=directory, device=dev)
        setup_s = time.perf_counter() - t0
        models = exp["models"]
        start = {name: {k: p.detach().clone() for k, p in
                        net.module.named_parameters()}
                 for name, net in models.items()}
        stats0 = {name: _bn_stats(models[name].module)
                  for name in ("generator_X", "discriminator_Y")}
        probe = torch.from_numpy(
            np.random.RandomState(3).uniform(-1, 1, (10, 256, 256, 3))
            .astype(np.float32)).to(dev)
        tie = _gan_tie(exp, probe)
        rec = {"epochs": [], "metrics": [],
               "copy_dir": os.path.join(tmp, "exp_after1")}
        _instrument_gan(exp, rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = exp["training"].run(exp["state"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated() / 1e9

        # --- what the run must show
        per_epoch = len(exp["loader"])
        metrics = [{k: float(v) for k, v in m.items()}
                   for m in rec["metrics"]]
        if len(metrics) != GAN_CUTS["epochs"] * per_epoch or per_epoch != 4:
            raise AssertionError("%d steps of %d an epoch"
                                 % (len(metrics), per_epoch))
        if not all(np.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError("non-finite metrics %s" % metrics)
        if metrics[0]["E_real"] != 0.0:
            raise AssertionError("step 1 E_real %r, not the exact tie"
                                 % metrics[0]["E_real"])
        moved, unmovable = {}, []
        for name, net in models.items():
            lrs = _max_adam_steps(exp, name, GAN_CUTS["epochs"])
            moved[name] = 0
            for k, p in net.module.named_parameters():
                if not torch.equal(p.detach(), start[name][k]):
                    moved[name] += 1
                elif k in lrs and _below_half_ulp(start[name][k],
                                                     lrs[k]):
                    # float32 cannot hold this update: a step of the lr is
                    # below half an ulp of every element (the published
                    # rates give HED's fusion 1e-6 x 0.001)
                    unmovable.append("%s.%s" % (name, k))
                    moved[name] += 1
        for name in ("generator_X", "discriminator_Y", "detector"):
            if moved[name] != len(start[name]):
                raise AssertionError("%s: %d of %d parameters moved; "
                                     "still: %s" % (name, moved[name],
                                                    len(start[name]), [
                    k for k, p in models[name].module.named_parameters()
                    if torch.equal(p.detach(), start[name][k])]))
        if moved["detector_frozen"]:
            raise AssertionError("the teacher moved")
        for name, st in stats0.items():
            now = _bn_stats(models[name].module)
            if any(torch.equal(v, now[k]) for k, v in st.items()):
                raise AssertionError("%s: a BatchNorm statistic unchanged"
                                     % name)
        files = set(os.listdir(os.path.join(directory, "epochs")))
        blobs = set(os.listdir(os.path.join(directory, "epochs", "blobs")))
        want_files = {"%s_%s.ckpt" % (n, s) for n in models
                      for s in ("epoch_02", "last", "best")} \
            | {"training_epoch_02.pkl", "events.json", "htmlreport",
               "detector_frozen_frozen.ckpt"}
        want_blobs = {"data_real_X_image0.rgb_epoch_01.jpg",
                      "data_fake_Y_image0.rgb_epoch_01.jpg",
                      "data_real_E_check_image0.chan1_epoch_01.jpg"} \
            | {"val_visual_val_%d_epoch_%02d.jpg" % (i, e)
               for i in range(4) for e in (1, 2)}
        report = os.path.join(directory, "epochs", "htmlreport",
                              "index.html")
        if not (want_files <= files and want_blobs <= blobs
                and os.path.getsize(report) > 0):
            raise AssertionError("files missing: %s %s" % (
                sorted(want_files - files), sorted(want_blobs - blobs)))
        print("GAN train launches: %s (HED^N-GAN reaches no kernel of the "
              "port: cuDNN float32)" % json.dumps(counts))

        # --- the parts of the run and the card's busy share
        prof = rec.pop("prof")
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        batch = cfg["data"]["train"]["loader"]["batch_size"]
        loop_ms = 1e3 * rec["epochs"][1]["steps_s"] / per_epoch
        out = {"setup_s": setup_s, "run_s": wall, "steps": len(metrics),
               "launches": counts, "student_equals_teacher_at_start": tie,
               "step1_E_real": metrics[0]["E_real"],
               "unmovable_in_float32": unmovable,
               "epochs": rec["epochs"], "loop_ms_per_step_epoch2": loop_ms,
               "loop_images_per_s": 1e3 * batch / loop_ms,
               "epoch2_steps_busy_share": busy_us / 1e6 / rec["prof_wall"],
               "epoch2_steps_wall_s": rec["prof_wall"],
               "peak_mem_gb_loop": peak,
               "last_metrics": metrics[-1]}

        # --- resume a copy of the directory as it was after epoch 1
        rcfg = gan_train_config(tmp, lists)
        rcfg["learning"]["checkpoints"]["directory"] = rec["copy_dir"]
        rexp = build_gan_experiment(rcfg, directory=rec["copy_dir"],
                                    device=dev)
        rstate, start_epoch = rexp["training"].resume_or_start(rexp["state"])
        if start_epoch != 2 or rstate.step != per_epoch:
            raise AssertionError("resume at %d, step %d"
                                 % (start_epoch, rstate.step))
        rstate = rexp["training"].run(rstate, start_epoch=start_epoch)
        for name, net in state.models.items():
            got = rstate.models[name].module.state_dict()
            for k, v in net.module.state_dict().items():
                if not torch.equal(v, got[k]):
                    raise AssertionError("resume: %s.%s differs by %g" % (
                        name, k, float((v.double() - got[k].double())
                                       .abs().max())))
        for name, opt in state.optimizers.items():
            want = opt.state_dict()["state"]
            got = rstate.optimizers[name].state_dict()["state"]
            for i, s in want.items():
                for k, v in s.items():
                    if not torch.equal(v, got[i][k]):
                        raise AssertionError("resume: %s moment %s.%s"
                                             % (name, i, k))
        out["resume"] = {"start_epoch": start_epoch,
                         "epoch2_bit_equal": True}
        del rexp, rstate

        # --- the trained generator in the hub, serving one photo
        gen = hub.hedngan(pretrained=True, checkpoint=os.path.join(
            directory, "epochs", "generator_X_last.ckpt"))
        img = np.random.RandomState(4).randint(0, 256, HW + (3,),
                                               dtype=np.uint8)
        y = gen(gen.transform(img)[None])
        if tuple(y.shape) != (1,) + HW + (3,) or not bool(
                torch.isfinite(y).all()) or float(y.abs().max()) > 1:
            raise AssertionError("hub generator: %s" % (tuple(y.shape),))
        out["hub_generator"] = {"shape": list(y.shape),
                                "ms": cuda_ms(lambda: gen(
                                    gen.transform(img)[None]), reps=3)}
        del gen

        # --- the bare step, its parts, and the card against the CPU
        X, Y = (torch.from_numpy(a).to(dev) for a in next(iter(
            exp["loader"])))
        out["bare_step_ms"] = cuda_ms(
            lambda: exp["step"](exp["state"], X, Y), reps=3)
        out["bare_images_per_s"] = 1e3 * batch / out["bare_step_ms"]
        out["step_breakdown_ms"] = gan_step_breakdown(exp, X, Y)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del exp, state, models
        torch.cuda.empty_cache()
        print("GAN training on the card: %s" % json.dumps(out))
        out["parity"] = _gan_parity(dev, lists, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print("GAN training (train_hedngan.yml, full width, 2 epochs of 4 steps "
          "at batch 10, 256x256), card vs CPU: %s"
          % json.dumps(out["parity"]))
    return out


# ---- the scenario CLI: hedngan.yml's `all` and `output` targets and
# cyclegan.yml's `train` target through gandtr_tpu_torch.scenarios.run
ICCV23_TRAIN = ROOT / "gandtr_tpu" / "scenarios" / "configs" / "iccv23" / \
    "train"
HEDNGAN_YML = str(ICCV23_TRAIN / "hedngan.yml")
CYCLEGAN_YML = str(ICCV23_TRAIN / "cyclegan.yml")
SFM = "data/train/retrieval-SfM-120k"
SCEN_TEST_DB, SCEN_TEST_Q = 24, 3       # photos a test set
SCEN_OUTPUT = 8                         # photos the output target writes
SCEN_OUTPUT_SHAPES = [(272, 362), (362, 272)]


def _scenario_cuts(prefix, epochs, schedulers):
    """key=value overrides of an epochs / schedule / checkpoint cut."""
    out = ["%slearning.training.epochs=%d" % (prefix, epochs)]
    out += ["%slearning.training.scheduler.%s.n_epochs_decay=1"
            % (prefix, name) for name in schedulers]
    return out + ["%slearning.checkpoints.checkpoint_every=1" % prefix,
                  "%slearning.checkpoints.store_every=2" % prefix]


def all_target_overrides(embed_init):
    """hedngan.yml's `all` target cut by the CLI's own key=value
    overrides (PERF.md section 4, "Scenario CLI"): the GAN as GAN_CUTS
    cuts it, with the HED files `pretrained: null` (seeded); the fine-tune
    as finetune_loop_config cuts it, the embed in bf16 (K2) and its
    `pretrained: true` a seeded local file; whitening's dataset_pkl the
    local SfM-120k whitening pickle."""
    gan, ft = "all.1_train_augment.", "all.2_finetune_embed."
    out = _scenario_cuts(gan, GAN_CUTS["epochs"],
                         ("generator_X", "discriminator_Y", "detector"))
    out += ["%sdata.train.dataset.size=%d" % (gan, GAN_CUTS["size"]),
            "%slearning.validation.visual.frequency=%d"
            % (gan, GAN_CUTS["frequency"])]
    out += ["%snetwork.%s.model.pretrained=null" % (gan, k)
            for k in ("detector", "detector_frozen")]
    out += _scenario_cuts(ft, LOOP_EPOCHS, ())
    out += ["%sdata.train.dataset.%s=%d" % (ft, k, v)
            for k, v in LOOP_CUTS.items()]
    out += [ft + "network.embed.runtime.dtype=\"bfloat16\"",
            ft + "network.embed.model.pretrained=%s" % json.dumps(embed_init),
            "all.3_train_whitening.whitening.dataset_pkl=\"%s/"
            "retrieval-SfM-120k-whiten.pkl\"" % SFM]
    return out


def cyclegan_overrides():
    """cyclegan.yml's `train` target at full width (ngf 64, 256x256 crops,
    batch 1 as shipped), cut to 2 epochs of 4 steps."""
    pre = "train.1_train_augment."
    return _scenario_cuts(pre, 2, ("generator_X", "generator_Y",
                                   "discriminator_X", "discriminator_Y")) + [
        pre + "data.train.dataset.size=4",
        pre + "learning.validation.visual.frequency=1"]


def make_scenario_data(root, seed=0):
    """The data/ tree the download checks expect, under root (the run's
    $GANDTR_ROOT), with seeded photos: SfM-120k's cid tree holding the
    tuple set of make_tuple_set (180 photos in 60 clusters) with its
    database and whitening pickles, day and night lists of 30 photos each
    (those that take a 256x256 crop; the night ones darkened copies), the
    four VAL_IMS photos, and the
    three test sets (make_eval_set); plus SCEN_OUTPUT PNG photos for the
    output target. Returns their names and the embed's initial weights."""
    import pickle
    from PIL import Image
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models import initialize_model
    from gandtr_tpu_torch.utils.download import TEST_SETS, VAL_IMS
    sfm = os.path.join(root, SFM)
    make_tuple_set(sfm, seed=seed, cids=True)
    with open(os.path.join(sfm, "retrieval-SfM-120k.pkl"), "rb") as f:
        db = pickle.load(f)["train"]
    with open(os.path.join(sfm, "retrieval-SfM-120k-whiten.pkl"), "wb") as f:
        pickle.dump({"cids": db["cids"], "qidxs": db["qidxs"],
                     "pidxs": db["pidxs"]}, f)
    ims = os.path.join(sfm, "ims")
    # the GAN's photos: those whose shorter side takes a 256x256 crop
    # (LOOP_SHAPES' fourth, 362x204, does not)
    fits = [c for i, c in enumerate(db["cids"])
            if min(LOOP_SHAPES[i % len(LOOP_SHAPES)]) >= 256]
    day = [cid_path(c) for c in fits[:GAN_DOMAIN]]
    night = []
    for i, name in enumerate(fits[GAN_DOMAIN:2 * GAN_DOMAIN]):
        arr = np.asarray(Image.open(os.path.join(ims, cid_path(name))))
        cid = "%032x" % (0x9e3779b9 * (i + 1) + seed)
        path = os.path.join(ims, cid_path(cid))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray((arr * 0.35).astype(np.uint8)).save(
            path, format="JPEG", quality=90)
        night.append(cid_path(cid))
    os.makedirs(os.path.join(sfm, "dataset"))
    for name, names in (("train_day.txt", day), ("train_night.txt", night)):
        with open(os.path.join(sfm, "dataset", name), "w") as f:
            f.write("\n".join(names) + "\n")
    rs = np.random.RandomState(seed + 1)
    for cid, (h, w) in zip(VAL_IMS, GAN_VAL_SHAPES):
        path = os.path.join(ims, cid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
            path, format="JPEG")
    for i, ds in enumerate(TEST_SETS):
        make_eval_set(os.path.join(root, "data", "test"), seed=seed + 2 + i,
                      name=ds, n_db=SCEN_TEST_DB, n_q=SCEN_TEST_Q)
    out_names = []
    for i in range(SCEN_OUTPUT):
        h, w = SCEN_OUTPUT_SHAPES[i % len(SCEN_OUTPUT_SHAPES)]
        out_names.append("output_src/day_%d.png" % i)
        path = os.path.join(ims, out_names[-1])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        small = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(path)
    embed = initialize_model(FINETUNE["network"]["embed"]["model"])
    _init_random(embed, seed + 7)
    embed_init = os.path.join(root, "embed_init.pth")
    torch.save({"model_state": embed.state_dict()}, embed_init)
    return out_names, embed_init


def _timed_functions(run_mod, times):
    """Wrap every stage of the CLI's table: each run appends (function,
    seconds to its end on the card)."""
    orig = dict(run_mod.FUNCTIONS)

    def timed(name, fn):
        def stage(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append((name, time.perf_counter() - t0))
            return out
        return stage
    run_mod.FUNCTIONS.update({k: timed(k, v) for k, v in orig.items()})
    return orig


def _cli(argv, capture):
    """run.main(argv) in this process; its step metadata and its stdout
    (echoed after) kept in `capture`."""
    import contextlib
    import io
    from gandtr_tpu_torch.scenarios import run
    results, times = {}, []
    orig_run, orig_fns = run.run_target, _timed_functions(run, times)

    def recording(*args, **kwargs):
        results.update(orig_run(*args, **kwargs))
        return results
    run.run_target = recording
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run.main(argv)
    finally:
        run.run_target = orig_run
        run.FUNCTIONS.clear()
        run.FUNCTIONS.update(orig_fns)
        sys.stdout.write(buf.getvalue()[-4000:])
    if rc != 0:
        raise AssertionError("%s returned %r" % (argv, rc))
    capture.update(results=results, stdout=buf.getvalue(),
                   step_seconds=[(step, secs) for step, (_, secs) in
                                 zip(results, times)])
    return results


def _instrumented_gan_builds(recs, profile_epoch=2, snapshot=False):
    """Patch the GAN build the train stage calls: each experiment gets
    _instrument_gan with a record of its own (appended to `recs`), with
    its starting parameters under "start" when `snapshot`; `profile_epoch`
    None profiles no epoch. Returns the original, to put back."""
    from gandtr_tpu_torch.scenarios import build
    orig = build.build_gan_experiment

    def instrumented(*args, **kwargs):
        exp = orig(*args, **kwargs)
        d = exp["checkpoints"].directory
        recs.append({"epochs": [], "metrics": [], "exp": exp,
                     "copy_dir": d.rstrip("/") + "_after1",
                     "profile_epoch": profile_epoch})
        if snapshot:
            recs[-1]["start"] = {
                name: {k: p.detach().clone() for k, p in
                       net.module.named_parameters()}
                for name, net in exp["models"].items()}
        _instrument_gan(exp, recs[-1])
        return exp
    build.build_gan_experiment = instrumented
    return orig


def _device_busy_us(prof):
    """The card's busy time in a finished torch.profiler run: the union of
    its device events' intervals, read from the raw kineto events (kernels
    that overlap on two streams count once; building the FunctionEvent
    list of a long trace takes tens of seconds)."""
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _gan_loop_numbers(rec):
    """ms a step in epoch 2 (the profiled epoch) and the card's busy share
    over its steps (`_device_busy_us`)."""
    prof = rec.pop("prof")
    busy_us = _device_busy_us(prof)
    steps = len(rec["exp"]["loader"])
    epoch = rec.get("profile_epoch", 2)
    return {"steps_an_epoch": steps,
            "loop_ms_per_step_epoch%d" % epoch:
                1e3 * rec["epochs"][epoch - 1]["steps_s"] / steps,
            "epoch%d_steps_busy_share" % epoch:
                busy_us / 1e6 / rec["prof_wall"],
            "epochs": rec["epochs"]}


def _check_all_target(root, res, stdout, counts):
    """Each step's artifact, the mAPs, the printed scores, the launches."""
    import pickle
    from gandtr_tpu_torch.utils.download import TEST_SETS
    gan_dir = os.path.join(root, "experiments", "gan", "hedngan", "epochs")
    ft_dir = os.path.join(root, "experiments", "cirtorch", "vgg16_hedngan")
    lw_path = os.path.join(ft_dir, "whitening", "lw-retrieval.pkl")
    for path in (os.path.join(gan_dir, "generator_X_best.ckpt"),
                 os.path.join(ft_dir, "epochs", "embed_best.ckpt"), lw_path,
                 os.path.join(root, "data", "val", "day_night", "4.jpg")):
        if not os.path.exists(path):
            raise AssertionError("the all target left no %s" % path)
    with open(lw_path, "rb") as f:
        lw = pickle.load(f)
    if lw["P"].shape != (512, 512) or not np.isfinite(lw["P"]).all():
        raise AssertionError("Lw P %s" % (lw["P"].shape,))
    if res["3_train_whitening"]["whitening_path"] != lw_path:
        raise AssertionError("whitening at %r"
                             % res["3_train_whitening"]["whitening_path"])
    val = res["5_evaluate"]["metadata"]["validation"]
    maps = {k: v for k, v in val.items() if "score_avg:map" in k}
    want = {"%s/validation/score_avg:map_%s" % (ds, p) for ds in TEST_SETS[:2]
            for p in ("easy", "medium", "hard")} \
        | {"247tokyo1k/validation/score_avg:map"}
    if set(maps) != want or not all(np.isfinite(v) for v in maps.values()):
        raise AssertionError("mAPs %s" % maps)
    for label in ("roxford.5k medium", "rparis.6k medium", "247tokyo.1k"):
        if label not in stdout:
            raise AssertionError("print_scores printed no %r" % label)
    for step in ("1_train_augment", "2_finetune_embed"):
        meta = res[step]
        if not {"metrics", "metrics_series", "best_epoch", "resource_usage",
                "code_version", "directory"} <= set(meta):
            raise AssertionError("%s metadata %s" % (step, sorted(meta)))
    if not (counts["K4"] > 0 and counts["K2"] > 0 and counts["K1"] == 0
            and counts["K3"] == 0):
        raise AssertionError("all-target launches %s: K4 and K2 > 0, K1 0 "
                             "(eval.yml's shape_bucket 64), K3 0" % counts)
    return maps


def check_recorded_k2_k4(calls):
    """K4 and K2 on every input the `all` target gave them (`calls`:
    {"K4": [(args, kwargs)], "K2": [...]}, recorded by reference while
    the launches were counted): each call launched again (after the
    counts were read) and held against its plain version, K4 bit for bit
    and K2 within check_k2's bounds (2e-2 of 1 + |plain| for bf16 out,
    2e-5 for float32 out). Returns {kernel: {calls, shapes, max_abs_err}}."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    from gandtr_tpu_torch.ops.vggconv import conv3x3_same_plain
    set_float32_policy()        # the plain conv in full float32
    out = {}
    for k in ("K4", "K2"):
        shapes, err = set(), 0.0
        for args, kwargs in calls[k]:
            if k == "K4":
                got = kmasked.clahe_u8_masked_cuda(*args, **kwargs)
                want = clahe_u8_masked_plain(*args, **kwargs)
                ok = torch.equal(got, want)
                d = float((got.int() - want.int()).abs().max())
            else:
                x, wmat, bias, relu, out_dtype = args
                got = kvgg.conv3x3_same_cuda(x, wmat, bias, relu, out_dtype)
                want = conv3x3_same_plain(
                    x, wmat.view(3, 3, x.shape[-1], -1), bias, relu,
                    out_dtype)
                ok, d = _within(got, want, 2e-2 if out_dtype ==
                                torch.bfloat16 else 2e-5)
            if not ok:
                raise AssertionError("%s on the all target's input %s: "
                                     "%g from its plain version"
                                     % (k, tuple(args[0].shape), d))
            shapes.add(tuple(args[0].shape))
            err = max(err, d)
        torch.cuda.synchronize()
        out[k] = {"calls": len(calls[k]), "shapes": len(shapes),
                  "max_abs_err": err}
    return out


def _run_output_target(root, names):
    """The output target in a process of its own, the names on stdin."""
    env = dict(os.environ, GANDTR_ROOT=root)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gandtr_tpu_torch.scenarios.run", "output",
         HEDNGAN_YML], input="\n".join(names) + "\n", text=True,
        capture_output=True, cwd=str(ROOT), env=env, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("output target rc %d:\n%s%s" % (
            proc.returncode, proc.stdout[-3000:], proc.stderr[-3000:]))
    return secs


def _check_output(root, names, dev):
    """One PNG a name, each within one uint8 level of the trained
    generator (generator_X_best.ckpt) applied directly; returns the files'
    bytes."""
    from PIL import Image
    from gandtr_tpu_torch import hub
    gen = hub.hedngan(pretrained=True, checkpoint=os.path.join(
        root, "experiments", "gan", "hedngan", "epochs",
        "generator_X_best.ckpt"))
    out_dir = os.path.join(root, "experiments", "gan", "hedngan", "output")
    files, worst = {}, 0
    for name in names:
        path = os.path.join(out_dir, name)
        with open(path, "rb") as f:
            files[name] = f.read()
        got = np.asarray(Image.open(path))
        src = np.asarray(Image.open(os.path.join(root, SFM, "ims", name))
                         .convert("RGB"))
        with torch.no_grad():
            y = gen(gen.transform(src)[None])[0].float().cpu().numpy()
        want = np.clip((y.astype(np.float64) * 0.5 + 0.5) * 255, 0,
                       255).astype(np.uint8)
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError("output %s: %s" % (name, got.shape))
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    if worst > 1:
        raise AssertionError("output PNGs %d levels from the generator"
                             % worst)
    n_files = sum(len(f) for _, _, f in os.walk(out_dir))
    if n_files != len(names):
        raise AssertionError("%d files for %d names" % (n_files, len(names)))
    return files, worst


def _same_tree(a, b, where):
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError("resume differs at %s" % (where,))
    elif isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError("resume keys differ at %s" % (where,))
        for k in a:
            _same_tree(a[k], b[k], where + (k,))
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, where + (i,))
    elif a != b:
        raise AssertionError("resume differs at %s" % (where,))


CG_NETS = ("generator_X", "generator_Y", "discriminator_X",
           "discriminator_Y")
CG_IMAGES = ("fake_Y", "rec_X", "fake_X", "rec_Y")


def _cyclegan_step(cfg, where, X, Y, dtype=torch.float32):
    """One CycleGAN step of `cfg` built on `where`, in `dtype`: its losses,
    its fakes and reconstructions, and each network's gradient as its Adam
    update takes it (flat, on the host)."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    exp = build_gan_experiment(cfg, device=where)
    for net in exp["models"].values():
        net.module.to(dtype)
    grads = _grab_grads(exp, CG_NETS)
    _, m, dbg = exp["step"](exp["state"],
                            *(torch.from_numpy(a).to(where, dtype)
                              for a in (X, Y)))
    return ({k: float(v) for k, v in m.items()},
            {k: dbg[k].cpu().double() for k in CG_IMAGES},
            {k: _flat(grads[k]).double() for k in CG_NETS})


def _cyclegan_parity(dev, extra=(), hw=128,
                     inits=("normal_p2p", "kaiming_p2p")):
    """One step of cyclegan.yml's networks (full width, the shipped
    normal_p2p init) at batch 1 and 128x128, from the same seeded weights,
    in float64 and in float32 on the CPU and in float32 on the card, held
    as _gan_parity holds HED^N-GAN: the card's losses within 1e-3
    relative of the CPU's; the card's fakes and reconstructions and the
    four networks' gradients (each taken just before its Adam update: all
    four depend on the starting weights only, since the D steps take the
    starting generators' fakes) within twice the CPU float32's distance
    from float64 (L2, relative). As an extra check, with kaiming_p2p
    weights the losses within 1e-3 and the images within 1e-4 of the
    CPU's float32 (run_gan_train's bounds). `extra`: more key=value
    overrides; `hw`: the crop; `inits`: the weight schemes run."""
    from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
    cfg = load_yaml_scenario([CYCLEGAN_YML] + cyclegan_overrides()
                             + list(extra))
    cfg = cfg["train"]["1_train_augment"]
    cfg = {k: v for k, v in cfg.items() if k in ("network", "learning")}
    cfg["learning"]["checkpoints"]["directory"] = None
    rs = np.random.RandomState(9)
    X, Y = (rs.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32)
            for _ in range(2))
    torch.set_num_threads(os.cpu_count() or 1)
    out = {}
    for init in inits:
        for member in cfg["network"].values():
            if isinstance(member, dict) and member.get("initialize"):
                member["initialize"]["weights"] = init
        cpu = _cyclegan_step(cfg, "cpu", X, Y)
        card = _cyclegan_step(cfg, dev, X, Y)
        res = {"losses_max_rel": max(
                   abs(card[0][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu[0].items()),
               "images_max_abs": {k: float((card[1][k] - v).abs().max())
                                  for k, v in cpu[1].items()}}
        if init == "normal_p2p":
            ref = _cyclegan_step(cfg, "cpu", X, Y, torch.float64)
            for part, name in ((1, "images"), (2, "grads")):
                res[name + "_rel_to_float64_cpu"] = {
                    k: _rel(v, ref[part][k]) for k, v in cpu[part].items()}
                res[name + "_rel_to_float64_card"] = {
                    k: _rel(v, ref[part][k]) for k, v in card[part].items()}
            res["grads_rel_card_vs_cpu"] = {
                k: _rel(v, cpu[2][k]) for k, v in card[2].items()}
            del ref
        out[init] = res
        del cpu, card
    print("CycleGAN step, card vs CPU: %s" % json.dumps(out))
    n, k = out["normal_p2p"], out.get("kaiming_p2p")
    far = [(name, key) for name in ("images", "grads")
           for key, v in n[name + "_rel_to_float64_card"].items()
           if v > 2 * n[name + "_rel_to_float64_cpu"][key]]
    if far or n["losses_max_rel"] > 1e-3 or k is not None and (
            k["losses_max_rel"] > 1e-3
            or max(k["images_max_abs"].values()) > 1e-4):
        raise AssertionError("CycleGAN card vs CPU (past twice the CPU's "
                             "distance from float64: %s): %s" % (far, out))
    return out


def _k3_held(calls):
    """Each K3 block call [(args of ops/resblock.py::fused_resblock, the
    kernel's output)] against the plain version on the same inputs, by
    `_k3_on`'s rule; returns one (max, mean, elements over 0.06, ok, max
    |output|, details) a call."""
    from gandtr_tpu_torch.ops import resblock
    errs = []
    with torch.inference_mode():
        for args, out in calls:
            want = resblock.fused_resblock_plain(*args).float()
            d = (out.float() - want).abs()
            # one bf16 step of the output: 2^(exponent - 7)
            step = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(2.0 ** -126))) - 7)
            over = d > torch.maximum(step, torch.full_like(step, K3_MAX))
            # the kernel and the plain version against the float32 block,
            # everywhere and where they are further apart than the bound
            f32 = _block_f32(*(a.float() for a in args))
            ek, ep = (out.float() - f32).abs(), (want - f32).abs()
            between = (out.float() - f32) * (want - f32) <= 0
            ok = not bool(over.any()) or (
                bool((d[over] <= 2 * step[over]).all())
                and bool(between[over].all())
                and float(ek.max()) <= 1.01 * float(ep.max())
                and float(ek.mean()) <= 1.01 * float(ep.mean()))
            errs.append((float(d.max()), float(d.mean()),
                         int((d > K3_MAX).sum()), ok,
                         float(want.abs().max()),
                         {"kernel_vs_f32_max": float(ek.max()),
                          "plain_vs_f32_max": float(ep.max()),
                          "kernel_vs_f32_mean": float(ek.mean()),
                          "plain_vs_f32_mean": float(ep.mean()),
                          "past_bound": int(over.sum()),
                          "past_bound_abs_plain": [
                              float(want[over].abs().min()),
                              float(want[over].abs().max())]
                          if over.any() else [],
                          "past_bound_kernel_vs_f32_max": float(
                              ek[over].max()) if over.any() else 0.0,
                          "past_bound_plain_vs_f32_max": float(
                              ep[over].max()) if over.any() else 0.0}))
            del f32, ek, ep
    return errs


def _k3_on(gen, img):
    """The bf16 generator on one photo, K3 counted; each of its nine block
    calls held against K3's plain version on the same inputs: the mean
    difference under 0.01 and each element's within 0.06 or one bf16
    step of the output, whichever is larger (the trained net's block
    outputs pass 8, where one bf16 step is 0.0625; K3's own check holds
    0.06 at its test inputs' scale). An element past that bound passes
    only as two roundings of one value: within two bf16 steps of the
    plain version, with the float32 block (the same bf16 inputs, no
    rounding inside) between the two; and only in a call where the
    kernel's largest and mean distance from the float32 block are the
    plain version's within 1% (a trained CUT generator gave 3 such
    elements in 113M, at 4.7-6.6, 0.0625 apart: two steps there)."""
    from gandtr_tpu_torch.ops import resblock
    calls, kernel = [], resblock.fused_resblock

    def recording(*args, **kwargs):
        out = kernel(*args, **kwargs)
        calls.append((args, out))
        return out
    resblock.fused_resblock = recording
    reset_launches()
    try:
        with torch.inference_mode():
            y = gen(gen.transform(img)[None])
        torch.cuda.synchronize()
    finally:
        resblock.fused_resblock = kernel
    counts = launches()
    errs = _k3_held(calls)
    mx, mean = max(e[0] for e in errs), max(e[1] for e in errs)
    if counts["K3"] != 9 or len(calls) != 9 or mean >= K3_MEAN or \
            not all(e[3] for e in errs):
        raise AssertionError("K3 on the trained generator: %s "
                             "launches, %d calls, %s"
                             % (counts, len(calls), errs))
    if not bool(torch.isfinite(y.float()).all()):
        raise AssertionError("trained generator: not finite")
    return counts, {"max_abs_err": mx, "mean_abs_err": mean,
                    "over_0.06": sum(e[2] for e in errs),
                    "past_bound": sum(e[5]["past_bound"] for e in errs),
                    "max_abs_output": max(e[4] for e in errs),
                    "vs_f32_block": [e[5] for e in errs],
                    "block_calls": len(calls)}


def run_scenario(dev):
    """The scenario CLI on the card (the module docstring's item 12)."""
    import pickle
    import shutil
    import tempfile
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.scenarios import build
    tmp = tempfile.mkdtemp(prefix="scenario_", dir=os.environ.get("TMPDIR"))
    old_root = os.environ.get("GANDTR_ROOT")
    os.environ["GANDTR_ROOT"] = tmp
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "K4"), 0)}
    try:
        t0 = time.perf_counter()
        names, embed_init = make_scenario_data(tmp)
        out["data_s"] = time.perf_counter() - t0

        # hedngan.yml's `all` target, in this process
        recs, cap, calls = [], {}, {"K4": [], "K2": []}
        orig_build = _instrumented_gan_builds(recs)
        restore = (_recording_calls(kmasked, "clahe_u8_masked_cuda",
                                    calls["K4"]),
                   _recording_calls(kvgg, "conv3x3_same_cuda", calls["K2"]))
        import warnings
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                res = _cli(["all", HEDNGAN_YML]
                           + all_target_overrides(embed_init), cap)
                torch.cuda.synchronize()
                out["all_s"] = time.perf_counter() - t0
                counts = launches()
        finally:
            build.build_gan_experiment = orig_build
            for put_back in restore:
                put_back()
        unloaded = [str(w.message) for w in caught
                    if "not loaded" in str(w.message)]
        if unloaded:
            raise AssertionError("a network file was not loaded: %s"
                                 % unloaded)
        maps = _check_all_target(tmp, res, cap["stdout"], counts)
        held = check_recorded_k2_k4(calls)
        if held["K4"]["calls"] != counts["K4"] \
                or held["K2"]["calls"] != counts["K2"]:
            raise AssertionError("recorded %s for launches %s"
                                 % (held, counts))
        del calls
        out["all"] = {"launches": counts, "step_seconds": cap["step_seconds"],
                      "maps": maps, "held_vs_plain": held,
                      "gan": _gan_loop_numbers(recs[0])}
        for k, v in counts.items():
            out["launches"][k] += v
        print("scenario all target (hedngan.yml): %s" % json.dumps(
            out["all"]))
        del recs, res

        # the output target, twice, in a process of its own
        secs = [_run_output_target(tmp, names)]
        files, worst = _check_output(tmp, names, dev)
        secs.append(_run_output_target(tmp, names))
        again, _ = _check_output(tmp, names, dev)
        if again != files:
            raise AssertionError("the append run rewrote the output")
        out["output"] = {"seconds": secs, "images": len(names),
                         "max_level_vs_generator": worst,
                         "second_run_wrote_nothing": True}
        print("scenario output target: %s" % json.dumps(out["output"]))

        # cyclegan.yml's `train` target; the resume of epoch 2
        recs, cap = [], {}
        orig_build = _instrumented_gan_builds(recs)
        try:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            _cli(["train", CYCLEGAN_YML] + cyclegan_overrides(), cap)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = launches()
            copy_dir = recs[0]["copy_dir"]
            _cli(["train", CYCLEGAN_YML] + cyclegan_overrides() + [
                "train.1_train_augment.learning.checkpoints.directory=%s"
                % json.dumps(copy_dir)], {})
        finally:
            build.build_gan_experiment = orig_build
        gan_dir = os.path.join(tmp, "experiments", "gan", "cyclegan")
        for name in ("generator_X", "generator_Y", "discriminator_X",
                     "discriminator_Y"):
            _same_tree(*(torch.load(os.path.join(
                d, "epochs", "%s_epoch_02.ckpt" % name), weights_only=True)
                ["model_state"] for d in (gan_dir, copy_dir)), (name,))
        a, b = (torch.load(os.path.join(d, "epochs", "training_epoch_02.pkl"),
                           weights_only=True) for d in (gan_dir, copy_dir))
        for key in ("aux", "events", "rngs", "epoch"):
            _same_tree(a[key], b[key], (key,))
        if len(recs[1]["epochs"]) != 1:
            raise AssertionError("the resumed run ran %d epochs"
                                 % len(recs[1]["epochs"]))
        if any(counts.values()):
            raise AssertionError("CycleGAN training launched %s (float32 "
                                 "training reaches no kernel)" % counts)
        out["cyclegan"] = {"seconds": train_s, "launches": counts,
                           "step_seconds": cap["step_seconds"],
                           "gan": _gan_loop_numbers(recs[0]),
                           "resume_epoch2_bit_equal": True,
                           "pools": sorted(a["aux"]["pools"])}
        del recs
        out["cyclegan"]["parity"] = _cyclegan_parity(dev)

        # the trained generator served in bf16: K3 against its plain version
        gen = hub.cyclegan(pretrained=True, checkpoint=os.path.join(
            gan_dir, "epochs", "generator_X_last.ckpt"))
        gen.net.compute_dtype = torch.bfloat16
        img = np.random.RandomState(5).randint(0, 256, HW + (3,),
                                               dtype=np.uint8)
        counts, k3 = _k3_on(gen, img)
        out["cyclegan"]["k3_served"] = k3
        for k, v in counts.items():
            out["launches"][k] += v
        print("scenario cyclegan.yml train target: %s" % json.dumps(
            out["cyclegan"]))
        del gen
    finally:
        if old_root is None:
            os.environ.pop("GANDTR_ROOT", None)
        else:
            os.environ["GANDTR_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---- the paper's other GAN families: hedgan.yml, rcfgan.yml, rcfngan.yml
# and cut.yml's `train` targets through gandtr_tpu_torch.scenarios.run
FAMILY_YML = {name: str(ICCV23_TRAIN / ("%s.yml" % name))
              for name in ("hedgan", "rcfgan", "rcfngan", "cut")}
#: each family's cuts: epochs, pairs an epoch, the schedules cut to one
#: decay epoch, the detectors given seeded local files, resumed or not
FAMILY_CUTS = {
    "hedgan": {"epochs": 2, "size": 40, "resume": False,
               "schedulers": ("generator_X", "discriminator_Y"),
               "detectors": {"detector": "hed"}},
    "rcfgan": {"epochs": 1, "size": 40, "resume": False,
               "schedulers": ("generator_X", "discriminator_Y"),
               "detectors": {"detector": "rcf"}},
    "rcfngan": {"epochs": 2, "size": 40, "resume": True,
                "schedulers": ("generator_X", "discriminator_Y",
                               "detector"),
                "detectors": {"detector": "rcf", "detector_frozen": "rcf"}},
    "cut": {"epochs": 2, "size": 16, "resume": True,
            "schedulers": ("generator_X", "discriminator_Y", "featdown"),
            "detectors": {}},
}
#: the images each family's step returns (its debug dict)
FAMILY_IMAGES = {"hedgan": ("fake_Y", "real_E", "fake_E"),
                 "rcfgan": ("fake_Y", "real_E", "fake_E"),
                 "rcfngan": ("fake_Y", "real_E", "fake_E", "real_E_check"),
                 "cut": ("fake_Y", "idt_Y")}
FAMILY_PARITY_HW = 64     # the card-vs-float64 step's crops


def make_family_data(root, seed=0):
    """The SfM-120k layout the train targets' download check expects,
    under root (the run's $GANDTR_ROOT): make_domain_set's 30 day and 30
    night photos in its ims/ with the day / night lists, placeholder
    database pickles (the GAN stages do not read them), and the four
    validation photos at VAL_IMS's paths (the visual validation links
    them)."""
    import pickle
    import shutil
    from gandtr_tpu_torch.utils.download import VAL_IMS
    sfm = os.path.join(root, SFM)
    lists = make_domain_set(sfm, seed)
    os.makedirs(os.path.join(sfm, "dataset"))
    for path in lists:
        os.replace(path, os.path.join(sfm, "dataset",
                                      os.path.basename(path)))
    for name in ("retrieval-SfM-120k.pkl", "retrieval-SfM-120k-whiten.pkl"):
        with open(os.path.join(sfm, name), "wb") as f:
            pickle.dump({}, f)
    val = sorted(os.listdir(os.path.join(sfm, "val")))
    for cid, name in zip(VAL_IMS, val):
        dest = os.path.join(sfm, "ims", cid)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(os.path.join(sfm, "val", name), dest)


def seeded_detectors(root):
    """Seeded local .pth files of HED and RCF (the published
    hed_sniklaus_github.pth and rcf_bsds500_pascal_model.pth are not in
    the repository): {"hed": path, "rcf": path}."""
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models import initialize_model
    out = {}
    for i, (name, arch) in enumerate((("hed", "hed_interpolation"),
                                      ("rcf", "rcf"))):
        net = _init_random(initialize_model({"architecture": arch}), 40 + i)
        out[name] = os.path.join(root, "%s_seeded.pth" % name)
        torch.save(net.state_dict(), out[name])
    return out


def family_overrides(family, pth):
    """The family's `train` target at full width, cut by FAMILY_CUTS with
    the CLI's own key=value overrides."""
    cuts, pre = FAMILY_CUTS[family], "train.1_train_augment."
    out = _scenario_cuts(pre, cuts["epochs"], cuts["schedulers"])
    out += [pre + "data.train.dataset.size=%d" % cuts["size"],
            pre + "learning.validation.visual.frequency=1"]
    out += ["%snetwork.%s.model.pretrained=%s" % (pre, member,
                                                  json.dumps(pth[kind]))
            for member, kind in cuts["detectors"].items()]
    return out


def _family_step(cfg, where, X, Y, dtype=torch.float32):
    """One step of the family's train section `cfg` built on `where`, in
    `dtype`: its losses, its debug images and each optimised network's
    gradient as its Adam update takes it (flat, on the host)."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    exp = build_gan_experiment(cfg, device=where)
    for net in exp["models"].values():
        net.module.to(dtype)
    names = sorted(exp["optimizers"])
    grads = _grab_grads(exp, names)
    _, m, dbg = exp["step"](exp["state"],
                            *(torch.from_numpy(a).to(where, dtype)
                              for a in (X, Y)))
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().cpu().double() for k, v in dbg.items()},
            {k: _flat(grads[k]).double() for k in names})


def _family_parity(family, pth, dev, extra=(), tap_strides=(2, 4, 4, 4)):
    """One step of the family's train section at full width on
    FAMILY_PARITY_HW crops (batch 2; CUT batch 1 as shipped), from the same
    seeded weights in float64 and float32 on the CPU and in float32 on the
    card: the card's losses within 1e-3 relative of the CPU's; its debug
    images and every optimised network's gradient (taken just before its
    Adam update) within twice the CPU float32's distance from float64 (L2,
    relative). D's and the student's lr are 0 here, so that the G step's
    gradient goes through the starting D and student and depends on the
    starting weights only (Adam's first step would part float64 and
    float32 by its sign flips); CUT runs on fixed patch positions, its
    taps `tap_strides` below the crop. `extra`: more key=value
    overrides."""
    import functools
    from gandtr_tpu_torch.learning import gan_steps
    from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
    cfg = load_yaml_scenario([FAMILY_YML[family]]
                             + family_overrides(family, pth) + list(extra))
    cfg = cfg["train"]["1_train_augment"]
    cfg = {k: v for k, v in cfg.items() if k in ("network", "learning")}
    cfg["learning"]["checkpoints"]["directory"] = None
    for name in ("discriminator_Y", "detector"):
        if (cfg["learning"]["training"]["optimizer"] or {}).get(name):
            cfg["learning"]["training"]["optimizer"][name]["lr"] = 0.0
    batch = 1 if family == "cut" else 2
    rs = np.random.RandomState(11)
    X, Y = (rs.uniform(-1, 1, (batch, FAMILY_PARITY_HW, FAMILY_PARITY_HW, 3))
            .astype(np.float32) for _ in range(2))
    orig = gan_steps.GAN_STEPS["cut"]
    sizes = [(FAMILY_PARITY_HW // s) ** 2 for s in tap_strides]
    gan_steps.GAN_STEPS["cut"] = functools.partial(
        orig, fixed_patch_ids=[rs.permutation(n)[:256] for n in sizes])
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        ref = _family_step(cfg, "cpu", X, Y, torch.float64)
        cpu = _family_step(cfg, "cpu", X, Y)
        card = _family_step(cfg, dev, X, Y)
    finally:
        gan_steps.GAN_STEPS["cut"] = orig
    res = {"losses_max_rel": max(abs(card[0][k] - v) / max(abs(v), 1e-12)
                                 for k, v in cpu[0].items())}
    far = []
    for part, name in ((1, "images"), (2, "grads")):
        res[name + "_rel_to_float64_cpu"] = {
            k: _rel(v, ref[part][k]) for k, v in cpu[part].items()}
        res[name + "_rel_to_float64_card"] = {
            k: _rel(v, ref[part][k]) for k, v in card[part].items()}
        far += [(name, k) for k, v in res[name + "_rel_to_float64_card"]
                .items() if v > 2 * res[name + "_rel_to_float64_cpu"][k]]
    if sorted(card[1]) != sorted(set(FAMILY_IMAGES[family]) | {
            "real_X", "real_Y"}):
        raise AssertionError("%s debug images %s" % (family, sorted(card[1])))
    if far or res["losses_max_rel"] > 1e-3:
        raise AssertionError("%s card vs CPU (past twice the CPU's distance "
                             "from float64: %s): %s" % (family, far, res))
    return res


def rcf_timing(dev, batch=10, hw=256):
    """RCF's forward on the card at the GAN's batch and crop (seeded
    weights, no autograd), and forward + backward into its parameters as
    the student's E step runs it: ms (cuda_ms), the forward's conv FLOPs
    (conv_flops: its 32 convs, not the fixed upsampling) and rate, and
    whether two backward passes give the same gradients bit for bit
    (deterministic cuDNN: the dilated conv5, the ceil-mode pools, the
    fixed transposed convs)."""
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models import initialize_model
    net = _init_random(initialize_model({"architecture": "rcf"}), 40).to(dev)
    x = torch.from_numpy(np.random.RandomState(12).uniform(
        -1, 1, (batch, hw, hw, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        fwd = cuda_ms(lambda: net(x, no_sigmoid=True), reps=5)
        flop = conv_flops(net, lambda: net(x, no_sigmoid=True))

    def fwd_bwd():
        net.zero_grad(set_to_none=True)
        net(x, no_sigmoid=True).abs().mean().backward()
    both = cuda_ms(fwd_bwd, reps=3)
    grads = []
    for _ in range(2):
        fwd_bwd()
        grads.append([p.grad.clone() for p in net.parameters()])
    same = all(torch.equal(a, b) for a, b in zip(*grads))
    if not same:
        raise AssertionError("RCF's parameter gradients differ between "
                             "two backward passes on the card")
    return {"batch": batch, "hw": hw, "forward_ms": fwd,
            "forward_conv_gflop": flop / 1e9,
            "forward_tflop_s": flop / fwd / 1e9,
            "forward_backward_ms": both, "grads_repeat_bit_for_bit": same}


def _check_family_run(family, rec, directory):
    """Finite losses, every optimised parameter moved (or one whose lr is
    below half an ulp of each element), the frozen teacher unchanged, the
    visual validation and the epoch files written."""
    exp, cuts = rec["exp"], FAMILY_CUTS[family]
    metrics = [{k: float(v) for k, v in m.items()} for m in rec["metrics"]]
    steps = len(exp["loader"])
    if len(metrics) != cuts["epochs"] * steps or not all(
            np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("%s: %d steps, metrics %s"
                             % (family, len(metrics), metrics[-1:]))
    still, unmovable = [], []
    for name in exp["optimizers"]:
        lrs = _max_adam_steps(exp, name, cuts["epochs"])
        for k, p in exp["models"][name].module.named_parameters():
            if torch.equal(p.detach(), rec["start"][name][k]):
                if _below_half_ulp(rec["start"][name][k], lrs[k]):
                    unmovable.append("%s.%s" % (name, k))
                else:
                    still.append("%s.%s" % (name, k))
    if still:
        raise AssertionError("%s: parameters that did not move: %s"
                             % (family, still))
    for name, net in exp["models"].items():
        if name not in exp["optimizers"] and any(
                not torch.equal(p.detach(), rec["start"][name][k])
                for k, p in net.module.named_parameters()):
            raise AssertionError("%s: %s moved without an optimizer"
                                 % (family, name))
    epochs_dir = os.path.join(directory, "epochs")
    blobs = set(os.listdir(os.path.join(epochs_dir, "blobs")))
    want = {"val_visual_%d_epoch_%02d.jpg" % (i, cuts["epochs"])
            for i in range(1, 5)}
    want |= {"data_%s_image0.rgb_epoch_01.jpg" % k
             for k in FAMILY_IMAGES[family] if not k.endswith("_E")
             and k != "real_E_check"}
    files = set(os.listdir(epochs_dir))
    want_files = {"%s_last.ckpt" % n for n in exp["models"]} | {
        "events.json", "htmlreport"}
    if not (want <= blobs and want_files <= files):
        raise AssertionError("%s: missing %s %s" % (
            family, sorted(want - blobs), sorted(want_files - files)))
    return {"steps": len(metrics), "last_metrics": metrics[-1],
            "unmovable_in_float32": unmovable}


def _family_resume(family, tmp, copy_dir, names, pth, extra=()):
    """The train target (with the `extra` overrides) again on the copy of
    the directory after epoch 1: epoch 2's files of the networks `names`
    and the training file's optimizers, generator states, events and epoch
    bit-equal to the straight run's."""
    recs = []
    orig_build = _instrumented_gan_builds(recs, profile_epoch=None)
    try:
        _cli(["train", FAMILY_YML[family]] + family_overrides(family, pth)
             + list(extra)
             + ["train.1_train_augment.learning.checkpoints.directory=%s"
                % json.dumps(copy_dir)], {})
    finally:
        from gandtr_tpu_torch.scenarios import build
        build.build_gan_experiment = orig_build
    if len(recs[0]["epochs"]) != 1:
        raise AssertionError("the resumed %s run ran %d epochs"
                             % (family, len(recs[0]["epochs"])))
    gan_dir = os.path.join(tmp, "experiments", "gan", family)
    for name in names:
        _same_tree(*(torch.load(os.path.join(
            d, "epochs", "%s_epoch_02.ckpt" % name), weights_only=True)
            ["model_state"] for d in (gan_dir, copy_dir)), (family, name))
    a, b = (torch.load(os.path.join(d, "epochs", "training_epoch_02.pkl"),
                       weights_only=True) for d in (gan_dir, copy_dir))
    for key in ("aux", "events", "rngs", "epoch"):
        _same_tree(a[key], b[key], (family, key))
    return {"epoch2_bit_equal": True, "aux_rngs": sorted(a["aux"]["rngs"])}


def run_gan_families(dev):
    """The paper's other GAN families through the port's CLI on the card
    (the module docstring's item 13): hedgan.yml, rcfgan.yml, rcfngan.yml
    and cut.yml's `train` targets as shipped, at full width, cut by
    FAMILY_CUTS (HED-GAN and the RCF families: batch 10 of 256² crops, 40
    pairs, 2 epochs, RCF-GAN 1; CUT: batch 1 of 256², 16 pairs,
    dispatch_chunk 8, 2 epochs; the lr decay in the last epoch,
    checkpoint_every 1, store_every 2, the visual validation every epoch;
    HED's and RCF's published files -> seeded local .pth files), each
    with every launch count set to 0 just before it and read just after;
    then the checks, the resumes of RCF^N-GAN and CUT, each family's step
    against float64, RCF's forward, and the CUT-trained generator served
    through K3."""
    import shutil
    import tempfile
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.scenarios import build
    tmp = tempfile.mkdtemp(prefix="families_", dir=os.environ.get("TMPDIR"))
    old_root = os.environ.get("GANDTR_ROOT")
    os.environ["GANDTR_ROOT"] = tmp
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "K4"), 0)}
    try:
        t0 = time.perf_counter()
        make_family_data(tmp)
        pth = seeded_detectors(tmp)
        out["data_s"] = time.perf_counter() - t0
        for family, cuts in FAMILY_CUTS.items():
            recs, cap = [], {}
            orig_build = _instrumented_gan_builds(
                recs, profile_epoch=cuts["epochs"], snapshot=True)
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                _cli(["train", FAMILY_YML[family]]
                     + family_overrides(family, pth), cap)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                counts = launches()
            finally:
                build.build_gan_experiment = orig_build
            if any(counts.values()):
                raise AssertionError("%s training launched %s (float32 "
                                     "training reaches no kernel)"
                                     % (family, counts))
            rec = recs[0]
            res = {"seconds": train_s, "launches": counts,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "step_seconds": cap["step_seconds"],
                   **_check_family_run(family, rec, os.path.join(
                       tmp, "experiments", "gan", family)),
                   "gan": _gan_loop_numbers(rec)}
            names = list(rec.pop("exp")["models"])
            del rec["start"]
            if cuts["resume"]:
                res["resume"] = _family_resume(family, tmp, rec["copy_dir"],
                                               names, pth)
            del recs
            torch.cuda.empty_cache()
            res["parity"] = _family_parity(family, pth, dev)
            out[family] = res
            print("GAN family %s (train target): %s"
                  % (family, json.dumps(res)))
        out["rcf"] = rcf_timing(dev)
        print("RCF on the card: %s" % json.dumps(out["rcf"]))

        # the CUT-trained generator served in bf16: K3 against its plain
        # version on every block call
        gen = hub.cyclegan(pretrained=True, checkpoint=os.path.join(
            tmp, "experiments", "gan", "cut", "epochs",
            "generator_X_last.ckpt"))
        gen.net.compute_dtype = torch.bfloat16
        img = np.random.RandomState(6).randint(0, 256, HW + (3,),
                                               dtype=np.uint8)
        counts, k3 = _k3_on(gen, img)
        out["cut"]["k3_served"] = k3
        for k, v in counts.items():
            out["launches"][k] += v
        print("CUT-trained generator served: K3 %s" % json.dumps(k3))
        del gen
    finally:
        if old_root is None:
            os.environ.pop("GANDTR_ROOT", None)
        else:
            os.environ["GANDTR_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out

# ---- retrieval search and deployment (run_search)
SEARCH_DB = 1_001_001      # the R1M distractors of Radenovic et al., CVPR 2018
SEARCH_PHOTOS = 32         # seeded 768x1024 JPEGs indexed by build_index
SEARCH_QUERIES = 16        # queries of the exact-search check
SEARCH_PLANTS = 8          # photo rows planted again among the distractors
PQ_CFG = {"m": 16, "ksub": 256, "train_size": 25600, "iters": 25,
          "rerank": 100}
PQ_CHECK_ROWS = 65536      # rows whose PQ codes and scan the CPU repeats
CIRNET_VGG16 = {"architecture": "cirnet", "cir_architecture": "vgg16",
                "pooling": "gem", "local_whitening": False,
                "whitening": False}


def _plant_rows():
    """Distractor rows that hold copies of photo rows 0..SEARCH_PLANTS-1."""
    return [1000 + 125_000 * i for i in range(SEARCH_PLANTS)]


def make_search_photos(root, seed=0):
    """SEARCH_PHOTOS seeded 768x1024 JPEGs (smooth colour fields with
    noise, so that no two descriptors coincide); returns their names and
    the decoded uint8 arrays."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "photos"), exist_ok=True)
    yy, xx = np.mgrid[:HW[0], :HW[1]].astype(np.float32)
    names, arrays = [], []
    for i in range(SEARCH_PHOTOS):
        f = rng.uniform(20, 200, 3)
        base = 0.5 + 0.4 * np.sin(yy[..., None] / f + xx[..., None]
                                  / f[::-1] + rng.uniform(0, 6, 3))
        img = np.clip((base + 0.15 * rng.rand(*HW, 3)) * 255, 0, 255)
        name = "photo_%02d.jpg" % i
        path = os.path.join(root, "photos", name)
        Image.fromarray(img.astype(np.uint8)).save(path, quality=90)
        names.append(name)
        arrays.append(np.asarray(Image.open(path).convert("RGB")))
    return names, np.stack(arrays)


def _float64_topk(rows, queries, k):
    """[(indices, scores)] a query: the float64 host ranking, ties to the
    lower index."""
    q64 = queries.astype(np.float64)
    S = np.empty((rows.shape[0], q64.shape[0]), np.float64)
    for i in range(0, rows.shape[0], 1 << 17):
        S[i:i + (1 << 17)] = rows[i:i + (1 << 17)].astype(np.float64) @ q64.T
    out = []
    for j in range(q64.shape[0]):
        cand = np.argpartition(-S[:, j], 4 * k)[:4 * k]
        order = np.lexsort((cand, -S[cand, j]))[:k]
        out.append((cand[order], S[cand[order], j]))
    return out


def _check_exact(index, rows, names, queries, k=10):
    """The card's exact top-k of `queries` (photo rows) against the
    float64 host ranking: names equal (a difference only where float64
    says the scores are within 1e-6), and each planted copy right after
    its photo's own row."""
    got = index.query(queries, k=k)
    want = _float64_topk(rows, queries, k)
    plants = _plant_rows()
    near_ties = 0
    for j, (g, (idx, sc)) in enumerate(zip(got, want)):
        gn = [n for n, _ in g]
        wn = [names[i] for i in idx]
        if gn != wn:
            bad = [p for p in range(k) if gn[p] != wn[p]]
            if any(abs(sc[p] - sc[min(p + 1, k - 1)]) > 1e-6
                   and abs(sc[p] - sc[max(p - 1, 0)]) > 1e-6 for p in bad):
                raise AssertionError("exact search query %d: %s != %s"
                                     % (j, gn, wn))
            near_ties += 1
        if j < SEARCH_PLANTS:
            twin = "r%07d" % plants[j]
            if gn[:2] != [names[j], twin] or g[0][1] != g[1][1]:
                raise AssertionError("query %d: the planted twin %s did not "
                                     "follow its row: %s" % (j, twin, g[:3]))
        if not np.allclose([s for _, s in g], sc, atol=1e-5):
            raise AssertionError("exact scores %s vs float64 %s"
                                 % ([s for _, s in g], sc))
    return {"queries": len(got), "names_equal_float64": True,
            "near_ties_reordered": near_ties,
            "planted_twins_lower_index_first": SEARCH_PLANTS}


def _check_pq_against_cpu(index, rows):
    """PQ_CHECK_ROWS rows encoded again on the CPU with the card's
    codebooks: codes equal but where float64 puts the two centroids within
    1e-5; the ADC scan of those codes on the card within 1e-5 of the CPU
    scan, its top-10 names equal but at float32 near-ties."""
    from gandtr_tpu_torch.serving.index import exact_topk
    from gandtr_tpu_torch.serving.pq import encode_chunked
    m, dsub = index.m, index.dim // index.m
    sub = rows[:PQ_CHECK_ROWS]
    card = np.concatenate(index._codes, 0)[:PQ_CHECK_ROWS].astype(np.int64)
    cpu = encode_chunked(torch.from_numpy(index.codebooks), sub, m)
    diff = np.argwhere(card != cpu)
    C64 = index.codebooks.astype(np.float64)
    gaps = []
    for r, mi in diff:
        x = sub[r, mi * dsub:(mi + 1) * dsub].astype(np.float64)
        d = ((x - C64[mi, card[r, mi]]) ** 2).sum() - \
            ((x - C64[mi, cpu[r, mi]]) ** 2).sum()
        gaps.append(abs(d))
    if gaps and max(gaps) > 1e-5:
        raise AssertionError("PQ codes card vs CPU: %d differ, gaps up to %g"
                             % (len(gaps), max(gaps)))
    q = sub[:SEARCH_QUERIES]
    codes_t = torch.from_numpy(np.ascontiguousarray(card.T.astype(np.uint8)))
    with torch.inference_mode():
        s_card = index.scan(codes_t.cuda(), torch.from_numpy(
            index.codebooks).cuda(), torch.from_numpy(q).cuda())
        s_cpu = index.scan(codes_t, torch.from_numpy(index.codebooks),
                           torch.from_numpy(q))
        d = float((s_card.cpu() - s_cpu).abs().max())
        vg, ig = exact_topk(s_card, 10)
        vc, ic = exact_topk(s_cpu, 10)
    if d > 1e-5:
        raise AssertionError("PQ scan card vs CPU: %g" % d)
    reordered = int((ig.cpu() != ic).any(dim=1).sum())
    if reordered and float((vg.cpu() - vc).abs().max()) > 1e-5:
        raise AssertionError("PQ top-10 card vs CPU differ beyond near-ties")
    return {"rows": PQ_CHECK_ROWS, "codes_differing": len(gaps),
            "max_gap_where_differing": max(gaps) if gaps else 0.0,
            "scan_max_abs_err": d, "topk_rows_reordered_at_ties": reordered}


def _held_k1(calls):
    """Each distinct K1 call the served rounds recorded, bit-equal to the
    plain version on the same input."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    seen = {}
    with torch.inference_mode():
        for args, kwargs in calls:
            seen.setdefault((tuple(args[0].shape),) + tuple(args[1:]),
                            (args, kwargs))
        for key, (args, kwargs) in seen.items():
            if not torch.equal(kclahe.clahe_u8_cuda(*args, **kwargs),
                               clahe_u8_plain(*args, **kwargs)):
                raise AssertionError("K1 in the artifact differs from its "
                                     "plain version at %s" % (key,))
    return [list(k[0]) for k in seen]


def _timed(fn, reps=5):
    """Host milliseconds of one fn() that ends in a synchronisation."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def search_timings(exact, pq, rows):
    """Card times of a query's parts at Nq = 1 and 16 (CUDA events): the
    float32 matmul over the whole database and the exact top-k of its
    scores (the recursive chunked form; one torch.topk beside it), the
    PQ scan and its top-k; and each index's whole query() on the host
    clock."""
    from gandtr_tpu_torch.serving.index import exact_topk
    exact.build()
    pq.build()
    (_, db), = exact._shards
    (_, codes_t, C), = pq._shards
    out = {}
    with torch.inference_mode():
        for nq in (1, SEARCH_QUERIES):
            q = torch.from_numpy(rows[:nq]).cuda()
            s = torch.matmul(q, db.T)
            ps = pq.scan(codes_t, C, q)
            out["nq%d" % nq] = {
                "matmul_ms": cuda_ms(lambda: torch.matmul(q, db.T)),
                "topk_ms": cuda_ms(lambda: exact_topk(s, 10)),
                "one_torch_topk_ms": cuda_ms(lambda: torch.topk(s, 10)),
                "pq_scan_ms": cuda_ms(lambda: pq.scan(codes_t, C, q)),
                "pq_topk_ms": cuda_ms(lambda: exact_topk(ps, 100)),
                "exact_query_host_ms": _timed(
                    lambda: exact.query(rows[:nq], k=10)),
                "pq_query_host_ms": _timed(
                    lambda: pq.query(rows[:nq], k=10)),
            }
            del s, ps
    return out


def _search_answers(answers, index, direct, k=10):
    """Each :search answer equals index.query on the direct call's
    descriptor."""
    for i, (ctype, body) in enumerate(answers):
        got = json.loads(body)["results"]
        want = index.query(direct[i][None], k=k)[0]
        if ctype != "application/json" or [r["name"] for r in got] != \
                [n for n, _ in want] or not np.allclose(
                    [r["score"] for r in got], [s for _, s in want],
                    atol=1e-6):
            raise AssertionError(":search answer %d %s != %s"
                                 % (i, got[:3], want[:3]))
    return [json.loads(b)["results"] for _, b in answers]


def run_search(dev):
    """Retrieval search and deployment on the card (the module docstring's
    item 14): build_index and export through the scenario stages, the
    1,001,001-row database, the exact and PQ indexes, `:search` and the
    generator artifact on one serve_http, each check, the times."""
    import pickle
    import shutil
    import tempfile
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.scenarios import run as srun
    from gandtr_tpu_torch.serving import load_index
    from gandtr_tpu_torch.serving.export import (Servable, export_hub_model,
                                                 load_artifact)
    from gandtr_tpu_torch.serving.pq import PQRetrievalIndex
    from gandtr_tpu_torch.serving.service import encode_png, serve_http
    from PIL import Image
    tmp = tempfile.mkdtemp(prefix="search_", dir=os.environ.get("TMPDIR"))
    old_root = os.environ.get("GANDTR_ROOT")
    os.environ["GANDTR_ROOT"] = tmp
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "K4"), 0), "s": {}}
    t_phase = time.perf_counter()

    def lap(name, t0):
        torch.cuda.synchronize()
        out["s"][name] = time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        names, photos = make_search_photos(tmp)
        lw = seeded_lw()
        with open(os.path.join(tmp, "lw.pkl"), "wb") as f:
            pickle.dump(lw, f)
        seeded = hub.gem_vgg16_hedngan(pretrained=False, device="cpu")
        torch.save({"model_state": seeded.net.module.state_dict(),
                    "network_params": {"model": CIRNET_VGG16, "runtime": {
                        "data": dict(seeded.net.data_params)}}},
                   os.path.join(tmp, "net.pth"))
        del seeded
        # eval.yml's network form, path only: the model and its data
        # params (CLAHE) from the checkpoint, Lw then 3 scales
        network = {"path": "net.pth", "runtime": {"wrappers": {"eval": {
            "0_cirwhiten": {"whitening": "lw.pkl", "dimensions": None},
            "1_cirmultiscale": {"scales": True}}}}}
        lap("data", t0)

        reset_launches()
        t0 = time.perf_counter()
        res = srun.run_target({"t": {
            "1_index": {"__function__": "gandtr_tpu.stages.build_index",
                        "network": network,
                        "data": {"image_dir": "photos",
                                 "loader": {"batch_size": 8}},
                        "index": {"path": "index/photos.npz"}},
            "2_export": {"__function__": "gandtr_tpu.stages.export",
                         "network": network,
                         "export": {"directory": "artifacts/gem",
                                    "image_hw": list(HW),
                                    "batch_buckets": [1, 4, 8]}}}},
            "t", "search", stdin_data=names)
        lap("build_index_and_export", t0)
        stage_launches = launches()
        if res["1_index"]["count"] != SEARCH_PHOTOS or \
                stage_launches["K1"] < 1:
            raise AssertionError("build_index: %s, launches %s"
                                 % (res["1_index"], stage_launches))
        out["stages"] = {k: {kk: vv for kk, vv in v.items()}
                         for k, v in res.items()}

        t0 = time.perf_counter()
        gen = hub.cyclegan(pretrained=False)
        gen.net.compute_dtype = torch.bfloat16
        gen_dir = os.path.join(tmp, "artifacts", "gen")
        export_hub_model(gen, gen_dir, HW, batch_buckets=(1, 4, 8))
        lap("generator_export", t0)
        out["artifact_mb"] = {
            d: sum(os.path.getsize(os.path.join(tmp, "artifacts", d, f))
                   for f in os.listdir(os.path.join(tmp, "artifacts", d)))
            / 1e6 for d in ("gem", "gen")}

        # ---- the artifacts against the in-memory servables
        t0 = time.perf_counter()
        art = load_artifact(res["2_export"]["directory"])
        gen_art = load_artifact(gen_dir)
        mem = Servable(hub.gem_vgg16_hedngan(
            pretrained=True, checkpoint=os.path.join(tmp, "net.pth"),
            whitening=os.path.join(tmp, "lw.pkl")), HW)
        direct = art(photos[:N_REQ])
        d_mem = float(np.abs(direct - mem(photos[:N_REQ])).max())
        photo_index = load_index(os.path.join(tmp, "index", "photos.npz"))
        with np.load(os.path.join(tmp, "index", "photos.npz")) as z:
            photo_rows = z["vecs"]
        d_index = float(np.abs(direct - photo_rows[:N_REQ]).max())
        gen_direct = gen_art(photos[:N_REQ])
        gen_mem = Servable(gen, HW)(photos[:N_REQ])
        lap("artifact_checks", t0)
        if d_mem > 1e-5 or d_index > 1e-4:
            raise AssertionError("artifact descriptors vs in-memory %g, vs "
                                 "build_index rows %g" % (d_mem, d_index))
        if not np.array_equal(gen_direct, gen_mem):
            raise AssertionError("generator artifact differs from the "
                                 "in-memory path")
        out["artifact_vs_in_memory_max_abs"] = d_mem
        out["artifact_vs_index_rows_max_abs"] = d_index
        del mem

        # ---- the database: the photos' rows + the R1M-size distractors,
        # made on the card, with photo rows planted among them
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(13)
        X = torch.randn((SEARCH_DB, 512), generator=g, device=dev)
        X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
        distractors = X.cpu().numpy()
        del X
        for i, r in enumerate(_plant_rows()):
            distractors[r] = photo_rows[i]
        d_names = ["r%07d" % i for i in range(SEARCH_DB)]
        lap("distractors", t0)
        exact = photo_index          # the build_index file, on the card
        exact.add(d_names, distractors)
        t0 = time.perf_counter()
        exact.build()
        lap("exact_upload_2GB", t0)
        all_rows = np.concatenate([photo_rows, distractors], 0)
        all_names = names + d_names
        t0 = time.perf_counter()
        out["exact_check"] = _check_exact(exact, all_rows, all_names,
                                          photo_rows[:SEARCH_QUERIES])
        lap("exact_check_float64", t0)

        # ---- the PQ index on the same rows
        t0 = time.perf_counter()
        pq = PQRetrievalIndex(512, m=PQ_CFG["m"], ksub=PQ_CFG["ksub"],
                              rerank=PQ_CFG["rerank"])
        train = all_rows[np.random.RandomState(0).permutation(
            all_rows.shape[0])[:PQ_CFG["train_size"]]]
        pq.fit(train, iters=PQ_CFG["iters"])
        lap("pq_kmeans", t0)
        t0 = time.perf_counter()
        pq.add(all_names, all_rows)
        lap("pq_encode", t0)
        out["pq_rows_per_s"] = {
            "kmeans": PQ_CFG["train_size"] * PQ_CFG["iters"]
            / out["s"]["pq_kmeans"],
            "encode": all_rows.shape[0] / out["s"]["pq_encode"]}
        t0 = time.perf_counter()
        pq.build()
        lap("pq_upload", t0)
        t0 = time.perf_counter()
        out["pq_check"] = _check_pq_against_cpu(pq, all_rows)
        lap("pq_check_cpu", t0)
        out["times"] = search_timings(exact, pq, all_rows)

        # ---- one serve_http: :search with the exact and the PQ index,
        # :predict with the generator artifact
        server = serve_http({"exact": art, "pq": art, "gen": gen_art},
                            indices={"exact": exact, "pq": pq},
                            max_wait_ms=1000.0, block=False)
        k1_calls, k3_calls = [], []
        restore = _recording_calls(kclahe, "clahe_u8_cuda", k1_calls)
        k3_kernel = kres.fused_resblock_cuda

        def k3_recording(x, wmat1, b1, wmat2, b2, eps=1e-5):
            y = k3_kernel(x, wmat1, b1, wmat2, b2, eps)
            C = x.shape[-1]
            k3_calls.append(((x, wmat1.view(3, 3, C, C), b1,
                              wmat2.view(3, 3, C, C), b2), y))
            del k3_calls[:-9]          # the last batch's block calls
            return y
        kres.fused_resblock_cuda = k3_recording
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            timing = {}
            reset_launches()
            b0 = server.models["exact"].batcher.batches
            ex_answers, timing["exact"] = serve_rounds(
                base, "exact", photos, ":search?k=10")
            ex_launches = launches()
            ex_batches = server.models["exact"].batcher.batches - b0
            del k1_calls[:-4]
            reset_launches()
            pq_answers, timing["pq"] = serve_rounds(base, "pq", photos,
                                                    ":search?k=10")
            pq_launches = launches()
            reset_launches()
            b0 = server.models["gen"].batcher.batches
            gen_answers, timing["gen"] = serve_rounds(base, "gen", photos)
            gen_launches = launches()
            gen_batches = server.models["gen"].batcher.batches - b0
        finally:
            restore()
            kres.fused_resblock_cuda = k3_kernel
            server.close()
        for counts in (stage_launches, ex_launches, pq_launches,
                       gen_launches):
            for k, v in counts.items():
                out["launches"][k] += v
        out["serving"] = timing
        if ex_launches["K1"] < ex_batches or ex_launches["K3"]:
            raise AssertionError("descriptor artifact: %s launches for %d "
                                 "batches" % (ex_launches, ex_batches))
        if gen_launches["K3"] != 9 * gen_batches or not gen_batches:
            raise AssertionError("generator artifact: K3 %d for %d batches"
                                 % (gen_launches["K3"], gen_batches))
        got = _search_answers(ex_answers, exact, direct)
        for i, r in enumerate(got):
            if r[0]["name"] != names[i] or r[1]["name"] != "r%07d" % \
                    _plant_rows()[i] or r[0]["score"] != r[1]["score"]:
                raise AssertionError(":search %d: %s" % (i, r[:3]))
        _search_answers(pq_answers, pq, direct)
        for i, (ctype, body) in enumerate(gen_answers):
            if ctype != "image/png" or body != encode_png(gen_direct[i]):
                raise AssertionError("generator PNG %d differs" % i)
        out["k1_held"] = _held_k1(k1_calls)
        errs = _k3_held(k3_calls)
        if len(k3_calls) != 9 or max(e[1] for e in errs) >= K3_MEAN or \
                not all(e[3] for e in errs):
            raise AssertionError("K3 in the generator artifact: %s" % errs)
        out["k3_held"] = {"block_calls": len(k3_calls),
                          "max_abs_err": max(e[0] for e in errs),
                          "mean_abs_err": max(e[1] for e in errs)}
        out["served_launches"] = {"exact": ex_launches, "pq": pq_launches,
                                  "gen": gen_launches,
                                  "exact_batches": ex_batches,
                                  "gen_batches": gen_batches}
        del art, gen_art, gen, exact, pq, photo_index, server
        del distractors, all_rows, k1_calls, k3_calls
    finally:
        if old_root is None:
            os.environ.pop("GANDTR_ROOT", None)
        else:
            os.environ["GANDTR_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["s"]["phase"] = time.perf_counter() - t_phase
    return out


# ---- the training options: HED^N-GAN's knobs, SGD and the
# optimizer rotation, a warm start, the fine-tune's validations

OPT_DRIFT = 2            # separate steps before concat_student is compared
OPT_CACHE_BATCHES = 4    # the cache's fixed batches, fed 3 times
OPT_DSC_PAIRS = 80       # one epoch of 8 steps at batch 10
OPT_ROTATION = {"alternate_iteration": 2,
                "order": "generator_X,discriminator_Y,detector"}
OPT_SGD = {"algorithm": "sgd", "lr": 1e-6, "momentum": 0.9,
           "weight_decay": 0.0002}
OPT_VAL_CUTS = {"query_size": 20, "pool_size": 150}
OPT_RECORD_CAP = 4       # kernel calls kept a distinct input shape
OPT_SCORE_SIZE = 1024    # eval.yml's image_size for the score eval


def _gan_snapshot(exp):
    """Every net's state dict, on the host."""
    return {n: {k: v.detach().cpu().clone() for k, v in
                m.module.state_dict().items()}
            for n, m in exp["models"].items()}


def _gan_load(exp, snap):
    for n, sd in snap.items():
        exp["models"][n].module.load_state_dict(sd)


def _nets_differ(a, b):
    """The state-dict entries in which two experiments' nets differ."""
    sa, sb = _gan_snapshot(a), _gan_snapshot(b)
    return ["%s.%s" % (n, k) for n in sa for k in sa[n]
            if not torch.equal(sa[n][k], sb[n][k])]


def _seeded_gan_batches(n, batch, hw, seed):
    rs = np.random.RandomState(seed)
    return [tuple(rs.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


def _opt_cfg(root, lists, **knobs):
    """gan_train_config with epoch_iteration knobs."""
    cfg = gan_train_config(root, lists)
    cfg["learning"]["training"]["epoch_iteration"].update(knobs)
    return cfg


def student_gates(net, into, force=None, concat=False):
    """Forward hooks on the HED student's ReLUs and max-pools for the E
    step's forwards (its first two calls, real then fake; the one call
    on both with `concat`): each gate's decision, a ReLU's output > 0 or
    a max-pool's argmax, goes into `into` under "real:<module>" and
    "fake:<module>". With `force` (another run's decisions under the same
    keys) each gate routes by those instead, so two runs' gradients
    differ by their arithmetic alone. Returns the hook handles."""
    import torch.nn.functional as F
    from gandtr_tpu_torch.models.hed import MaxPool
    handles = []
    for name, mod in net.named_modules():
        if not isinstance(mod, (torch.nn.ReLU, MaxPool)):
            continue

        def hook(mod, inp, out, name=name, seen=[0]):
            k, seen[0] = seen[0], seen[0] + 1
            if k >= (1 if concat else 2):
                return None
            parts = ("real", "fake") if concat else (("real", "fake")[k],)
            x, pool = inp[0], isinstance(mod, MaxPool)
            nchw = x.permute(0, 3, 1, 2)
            got = (F.max_pool2d(nchw.detach(), 2, 2, return_indices=True)[1]
                   if pool else out.detach() > 0).cpu()
            for part, g in zip(parts, got.chunk(len(parts))):
                into["%s:%s" % (part, name)] = g
            if force is None:
                return None
            want = torch.cat([force["%s:%s" % (p, name)] for p in parts]
                             ).to(x.device)
            if not pool:
                return x * want.to(x.dtype)
            n, ch = want.shape[:2]
            y = nchw.reshape(n, ch, -1).gather(2, want.reshape(n, ch, -1))
            return y.reshape(want.shape).permute(0, 2, 3, 1)
        handles.append(mod.register_forward_hook(hook))
    return handles


def _opt_concat(dev, root, lists):
    """concat_student at batch 10, 256²: the E step's ms both ways (CUDA
    events, gan_step_breakdown) from the same state after OPT_DRIFT
    separate steps. At batch 2, 128², from those drifted weights: the
    student's E-step gradient with the knob on the card and on the CPU
    (float32) against the float64 CPU gradient without it (the same
    math), each routed by float64's ReLU and max-pool decisions: the
    card's within twice the CPU's distance (PERF.md §2). Printed beside
    them, unrouted: the distances and the gates each float32 run sets
    the other way from float64 (a gate near its switching point sends
    one element's whole gradient elsewhere; scripts/
    torch_e_grad_layers.py reads them layer by layer), and the card
    without the knob."""
    import copy
    from gandtr_tpu_torch.learning import gan_steps
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = gan_train_config(root, lists)
    cfg.pop("data")
    exp = build_gan_experiment(cfg, device=dev)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in _seeded_gan_batches(OPT_DRIFT + 1, 10, 256, 11)]
    for X, Y in batches[:OPT_DRIFT]:
        exp["step"](exp["state"], X, Y)
    snap, opt_snap = _gan_snapshot(exp), copy.deepcopy(
        exp["state"].state_dict())
    weights = cfg["learning"]["training"]["criterion"]["weights"]
    concat = gan_steps.build_hedngan_step(exp["models"], exp["optimizers"],
                                          weights, concat_student=True)
    X, Y = batches[-1]
    out = {}
    for name, step in (("separate", exp["step"]), ("concat", concat)):
        _gan_load(exp, snap)
        exp["state"].load_state_dict(copy.deepcopy(opt_snap))
        _, m, _ = step(exp["state"], X, Y)
        out["E_real_" + name] = float(m["E_real"])
        _gan_load(exp, snap)
        bd = gan_step_breakdown(dict(exp, step=step), X, Y)
        out["e_step_ms_" + name] = bd["e_step"]
        out["step_ms_" + name] = bd["total"]
    del exp, concat
    torch.cuda.empty_cache()

    # parity at batch 2, 128², from the drifted weights
    X, Y = (torch.from_numpy(a)
            for a in _seeded_gan_batches(1, 2, 128, 12)[0])
    ccfg = copy.deepcopy(cfg)
    ccfg["learning"]["training"]["epoch_iteration"]["concat_student"] = True
    torch.set_num_threads(os.cpu_count() or 1)
    g64 = {}

    def e_grad(where, c, dtype, gates, force=None):
        e = build_gan_experiment(c, device=where)
        _gan_load(e, snap)
        if dtype == torch.float64:
            for net in e["models"].values():
                net.module.double()
        hooks = student_gates(e["models"]["detector"].module, gates, force,
                              concat=c is ccfg)
        got = _grab_grads(e, ("detector",))
        _, m, _ = e["step"](e["state"], X.to(where, dtype),
                            Y.to(where, dtype))
        for h in hooks:
            h.remove()
        return _flat(got["detector"]).double(), [float(m["E_real"]),
                                                 float(m["E_fake"])]
    ref, out["E_128_float64_cpu"] = e_grad("cpu", cfg, torch.float64, g64)
    rel, flips = {}, {}
    for tag, where, c, force in (("cpu", "cpu", ccfg, g64),
                                 ("card", dev, ccfg, g64),
                                 ("cpu_unrouted", "cpu", ccfg, None),
                                 ("card_unrouted", dev, ccfg, None),
                                 ("card_separate_unrouted", dev, cfg, None)):
        gates = {}
        grad, m = e_grad(where, c, torch.float32, gates, force)
        rel[tag] = _rel(grad, ref)
        flips[tag] = {k: int((v != g64[k]).sum())
                      for k, v in gates.items() if (v != g64[k]).any()}
        if force is None:
            out["E_128_" + tag] = m
    out["e_grad_rel_to_float64"] = rel
    out["gates_other_way"] = flips
    if rel["card"] > 2 * rel["cpu"] or not out["E_real_separate"] > 0:
        raise AssertionError("concat_student: %s" % json.dumps(out))
    return out


def _opt_cache(dev, root, lists):
    """The build's teacher cache (`cache_teacher_targets`) and the plain
    build from the same seeded weights, fed OPT_CACHE_BATCHES batches of
    the domain loader three times in order: misses on the first pass,
    hits after, and the two runs bit-equal (nets and the three Adams).
    Host-clock ms of a miss and of a hit (synchronised), and of the plain
    step."""
    from gandtr_tpu_torch.data import transforms as T
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    plain = build_gan_experiment(gan_train_config(root, lists), device=dev)
    cfg = _opt_cfg(root, lists, cache_teacher_targets=True)
    cfg.pop("data")
    cached = build_gan_experiment(cfg, device=dev)
    if _nets_differ(plain, cached):
        raise AssertionError("the two builds start apart")
    T.seed_transforms(0)
    np.random.seed(0)
    plain["loader"].dataset.prepare_epoch()
    it = iter(plain["loader"])
    batches = [next(it) for _ in range(OPT_CACHE_BATCHES)]
    del it
    times = {"miss": [], "hit": [], "plain": []}
    step = cached["step"]
    for _ in range(3):
        for b in batches:
            for tag, fn in (("plain", lambda: plain["step"](
                    plain["state"], *(_upload(a, dev) for a in b[:2]))),
                            ("cached", lambda: step(
                                cached["state"], *step.batch_to_args(b)))):
                hits = step.hits
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                if tag == "plain":
                    times["plain"].append(ms)
                else:
                    times["hit" if step.hits > hits else "miss"].append(ms)
    diff = _nets_differ(plain, cached)
    for name, opt in plain["state"].optimizers.items():
        want = opt.state_dict()["state"]
        got = cached["state"].optimizers[name].state_dict()["state"]
        diff += ["%s moment %s.%s" % (name, i, k) for i, s in want.items()
                 for k, v in s.items() if not torch.equal(v, got[i][k])]
    out = {"hits": step.hits, "misses": step.misses,
           "bit_equal_to_uncached": not diff,
           "miss_ms": float(np.median(times["miss"])),
           "hit_ms": float(np.median(times["hit"][1:])),
           "plain_ms": float(np.median(times["plain"][1:]))}
    if diff or (step.hits, step.misses) != (2 * OPT_CACHE_BATCHES,
                                            OPT_CACHE_BATCHES):
        raise AssertionError("teacher cache: %s; differs: %s"
                             % (json.dumps(out), diff[:8]))
    return out


def _upload(arr, dev):
    from gandtr_tpu_torch.device import upload
    return upload(arr, dev)


def _opt_dsc(dev, root, lists):
    """The published `scalecrop:256_256:0.8_1` chain through the build's
    loader and `Training.run` (one epoch of OPT_DSC_PAIRS pairs, batch 10,
    a directory, the visual validation off), without and with
    `device_scalecrop`, from the same seed: the crop boxes equal, the first
    batch staged on the card within 1e-5 of the host chain's; the loader
    threads' host ms a step (the batches' making), the bytes uploaded a
    step, the epoch's ms a step and the card's busy share over it
    (torch.profiler), both ways. Returns (numbers, the device run's
    directory)."""
    from torch.profiler import ProfilerActivity, profile
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    out, first, boxes = {}, {}, {}
    for knob in (False, True):
        tag = "device" if knob else "host"
        cfg = gan_train_config(root, lists)
        cfg["learning"]["checkpoints"]["directory"] = os.path.join(
            root, "dsc_" + tag)
        cfg["learning"]["training"]["epochs"] = 1
        cfg["data"]["train"]["dataset"]["size"] = OPT_DSC_PAIRS
        cfg["data"]["train"]["device_scalecrop"] = knob
        cfg["learning"]["validation"]["visual"]["frequency"] = 0
        directory = cfg["learning"]["checkpoints"]["directory"]
        exp = build_gan_experiment(cfg, directory=directory, device=dev)
        loader, loop = exp["loader"], exp["training"].loop
        ds = loader.dataset
        rec = {"host_s": 0.0, "bytes": 0, "steps": 0, "boxes": []}
        lock = threading.Lock()
        make_batch, draw = loader._batch, ds.transform.draw
        to_args, run_epoch = loop.batch_to_args, loop.run_epoch

        def timed_batch(idxs, _make=make_batch, _rec=rec):
            t0 = time.perf_counter()
            batch = _make(idxs)
            with lock:
                _rec["host_s"] += time.perf_counter() - t0
            return batch

        def profiled_epoch(state, epoch, _run=run_epoch, _rec=rec):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state = _run(state, epoch)
                torch.cuda.synchronize()
                _rec["wall"] = time.perf_counter() - t0
            _rec["busy_us"] = sum(
                e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            return state

        def recording_draw(sizes, _draw=draw, _rec=rec, _knob=knob):
            d = _draw(sizes)
            _rec["boxes"].append(d if _knob else d[1])
            return d

        def counting_args(batch, _rec=rec, _to=to_args, _tag=tag):
            _rec["bytes"] += sum(np.asarray(a).nbytes for a in batch)
            _rec["steps"] += 1
            first.setdefault(_tag, [np.asarray(a).copy() for a in batch])
            return _to(batch)
        loader._batch = timed_batch
        ds.transform.draw = recording_draw
        loop.batch_to_args = counting_args
        loop.run_epoch = profiled_epoch
        t0 = time.perf_counter()
        exp["training"].run(exp["state"])
        torch.cuda.synchronize()
        steps = rec["steps"]
        out[tag] = {"loader_host_ms_per_step": 1e3 * rec["host_s"] / steps,
                    "bytes_uploaded_per_step": rec["bytes"] / steps,
                    "loop_ms_per_step": 1e3 * rec["wall"] / steps,
                    "busy_share": rec["busy_us"] / 1e6 / rec["wall"],
                    "run_s": time.perf_counter() - t0, "steps": steps}
        boxes[tag] = rec["boxes"]
        if tag == "device":
            stage = exp["step"].stage
            staged = [stage(_upload(first[tag][i], dev),
                            _upload(first[tag][i + 1], dev)).cpu().numpy()
                      for i in (0, 2)]
            dsc_dir = directory
        del exp
    d = max(float(np.abs(s - h).max())
            for s, h in zip(staged, first["host"][:2]))
    out["staged_vs_host_max"] = d
    out["boxes_equal"] = (
        [(list(map(int, o)), list(map(int, c))) for o, c in boxes["host"]]
        == [(list(map(int, o)), list(map(int, c))) for o, c in
            boxes["device"]])
    if not out["boxes_equal"] or d > 1e-5 or not (
            out["host"]["steps"] == out["device"]["steps"] == 8):
        raise AssertionError("device scalecrop: %s" % json.dumps(out))
    return out, dsc_dir


def _opt_rotation(dev, root, lists):
    """`composition: OPT_ROTATION` with the detector on SGD (momentum
    0.9): 6 steps at batch 10, 256², each moving exactly the active
    member's parameters (the others bit-unchanged); a build resumed from
    the nets and the state after step 3 repeats steps 4 to 6 bit for
    bit."""
    import copy
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = gan_train_config(root, lists)
    cfg.pop("data")
    opt = cfg["learning"]["training"]["optimizer"]
    opt["detector"] = dict(OPT_SGD)
    opt["composition"] = dict(OPT_ROTATION)
    order = OPT_ROTATION["order"].split(",")
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in _seeded_gan_batches(6, 10, 256, 13)]
    exp = build_gan_experiment(cfg, device=dev)
    moved, saved = [], None
    for t, (X, Y) in enumerate(batches):
        before = {n: [p.detach().clone() for p in
                      exp["models"][n].module.parameters()] for n in order}
        _, m, _ = exp["step"](exp["state"], X, Y)
        moved.append({n: sum(not torch.equal(a, p) for a, p in zip(
            before[n], exp["models"][n].module.parameters()))
            for n in order})
        if not all(np.isfinite(float(v)) for v in m.values()):
            raise AssertionError("rotation step %d: %s" % (t, m))
        if t == 2:
            saved = (_gan_snapshot(exp),
                     copy.deepcopy(exp["state"].state_dict()))
    for t, mv in enumerate(moved):
        active = order[(t // 2) % 3]
        if any(mv[n] for n in order if n != active) or not mv[active]:
            raise AssertionError("rotation step %d moved %s (active %s)"
                                 % (t, mv, active))
    again = build_gan_experiment(cfg, device=dev)
    _gan_load(again, saved[0])
    again["state"].load_state_dict(saved[1])
    for X, Y in batches[3:]:
        again["step"](again["state"], X, Y)
    diff = _nets_differ(exp, again)
    if diff:
        raise AssertionError("rotation resume differs: %s" % diff[:8])
    return {"moved_per_step": moved, "resume_steps_4_to_6_bit_equal": True,
            "detector_optimizer": type(
                exp["optimizers"]["detector"].optimizer).__name__}


def _opt_warm_start(dev, root, lists, dsc_dir):
    """A build whose generator_X is a `path:` member on the device
    scalecrop run's generator_X_last.ckpt: its weights are the file's
    before the first step, and the step runs."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    path = os.path.join(dsc_dir, "epochs", "generator_X_last.ckpt")
    cfg = gan_train_config(root, lists)
    cfg.pop("data")
    cfg["network"]["generator_X"] = {"type": "SingleNetwork", "path": path}
    exp = build_gan_experiment(cfg, device=dev)
    want = torch.load(path, map_location="cpu",
                      weights_only=False)["model_state"]
    got = exp["models"]["generator_X"].module.state_dict()
    diff = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
    X, Y = (torch.from_numpy(a).to(dev)
            for a in _seeded_gan_batches(1, 10, 256, 14)[0])
    _, m, _ = exp["step"](exp["state"], X, Y)
    if diff or set(want) != set(got) or not np.isfinite(float(m["total"])):
        raise AssertionError("warm start: %d entries differ, total %s"
                             % (len(diff), float(m["total"])))
    return {"weights_equal_file": True, "step_total": float(m["total"])}


def _capped_recording(module, name, calls, cap=OPT_RECORD_CAP):
    """_recording_calls keeping at most `cap` calls an input shape (the
    tensors by reference); returns the function that puts it back."""
    original = getattr(module, name)
    seen = {}

    def recording(*args, **kwargs):
        key = tuple(args[0].shape)
        seen[key] = seen.get(key, 0) + 1
        if seen[key] <= cap:
            calls.append((args, kwargs))
        return original(*args, **kwargs)
    setattr(module, name, recording)
    return lambda: setattr(module, name, original)


def _hold_clahe(calls, kernel, plain):
    """Each recorded CLAHE call's kernel bit-equal to its plain version."""
    for args, kwargs in calls:
        got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
        if not torch.equal(got, want):
            raise AssertionError("%s on %s: %d levels from its plain version"
                                 % (kernel.__name__, tuple(args[0].shape),
                                    int((got.int() - want.int()).abs()
                                        .max())))
    return len(calls)


def _plain_k2_k4():
    """Swap K2 and K4 for their plain versions; returns the function that
    puts them back."""
    from gandtr_tpu_torch.ops import clahe as clahe_ops
    from gandtr_tpu_torch.ops import vggconv
    k2, k4 = vggconv.conv3x3_same, clahe_ops.clahe_u8_masked
    vggconv.conv3x3_same = (lambda x, w, b=None, relu=False, out_dtype=None:
                            vggconv.conv3x3_same_plain(x, w, b, relu,
                                                       out_dtype))
    clahe_ops.clahe_u8_masked = clahe_ops.clahe_u8_masked_plain

    def restore():
        vggconv.conv3x3_same, clahe_ops.clahe_u8_masked = k2, k4
    return restore


def _val_loss_now(val, state):
    """One validation's tuples mined once with `state`'s weights and the
    kernels, then scored with the kernels and with K2 and K4 swapped for
    their plain versions, on the same host batches: {variant: (mean loss,
    launches)}, and the launches of the mining."""
    reset_launches()
    val.on_validate(state)
    val.loader.dataset.prepare_epoch()
    out = {"mining": launches()}
    batches = list(val.loader)
    for name in ("kernels", "plain"):
        restore = _plain_k2_k4() if name == "plain" else (lambda: None)
        try:
            reset_launches()
            with torch.no_grad():
                losses = [float(val.loss_fn(state, *val.batch_to_args(b)))
                          for b in batches]
            out[name] = (float(np.mean(losses)), launches())
        finally:
            restore()
    return out


def _triplet_step(dev):
    """One fine-tune step of finetune.yml with `criterion: {loss: triplet,
    margin: 0.1}` (T=2, bf16 embed), with the kernels and with K2 and K4
    swapped for their plain versions: finite, the losses within 1%."""
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    import copy
    batch = finetune_batch(dev, T=2, seed=3)
    cfg = finetune_config()
    cfg["learning"]["training"]["criterion"] = {"loss": "triplet",
                                                "margin": 0.1}
    exp = build_finetune_experiment(cfg, device=dev)
    embed = exp["models"]["embed"].module
    start = copy.deepcopy(embed.state_dict())
    res = {}
    for name in ("kernels", "plain"):
        embed.load_state_dict(start)
        restore = _plain_k2_k4() if name == "plain" else (lambda: None)
        try:
            reset_launches()
            _, m = exp["step"](exp["state"], *batch)
            res[name] = (float(m["total"]), launches())
        finally:
            restore()
    (lk, ck), (lp, cp) = res["kernels"], res["plain"]
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    if not (np.isfinite(lk) and rel <= 1e-2 and ck["K2"] and ck["K4"]
            and not cp["K2"] and not cp["K4"]):
        raise AssertionError("triplet step: kernels %r %s, plain %r %s"
                             % (lk, ck, lp, cp))
    return {"loss": lk, "loss_plain": lp, "rel": rel, "launches": ck}


def _opt_finetune(dev, root):
    """The fine-tune loop of finetune_loop_config (make_tuple_set's set) with
    a seeded val split of its own, a `learning.validation` section
    (frequency 1), `output.learning.tensorboard`, and a ScoreValidation
    over make_eval_set's roxford5k-style set (exact shapes: K1) appended to
    the training's validations; 2 epochs, every launch count set to 0
    just before the run. Checks: finite validation losses; the val
    tuples mined with each epoch's weights; `_best` at the lower loss;
    the score events under the JAX keys; the TensorBoard file's CRCs and
    its epoch scalars equal to the events' history; K4 and K2 launched by
    the loss validation and K1 by the score eval, each recorded call
    (OPT_RECORD_CAP an input shape) held against its plain version; one
    validation's tuples, mined once with the kernels (K4, K2), scored
    with K2 and with plain K2 and K4 on the same batches: the losses
    within 1%; the triplet step."""
    import pickle
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.learning.tensorboard import (read_records,
                                                       read_scalar_events)
    from gandtr_tpu_torch.learning.training import ScoreValidation
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    train_root, val_root = (os.path.join(root, d) for d in ("ft", "ftval"))
    with open(make_tuple_set(train_root), "rb") as f:
        train_db = pickle.load(f)["train"]
    with open(make_tuple_set(val_root, seed=1), "rb") as f:
        val_db = pickle.load(f)["train"]
    pkl = os.path.join(root, "tuples.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"train": train_db, "val": val_db}, f)
    eval_root = os.path.join(root, "evalset")
    make_eval_set(eval_root)
    cfg = finetune_loop_config(pkl, os.path.join(train_root, "ims"))
    cfg["data"]["val"] = {"dataset": dict(
        OPT_VAL_CUTS, name="CirTuples", split="val", neg_num=5,
        image_dir=os.path.join(val_root, "ims"))}
    cfg["learning"]["validation"] = {"type": "SingleValidation",
                                     "frequency": 1}
    cfg["output"]["learning"]["tensorboard"] = {}
    directory = os.path.join(root, "ftexp")
    exp = build_finetune_experiment(cfg, directory, device=dev)
    training = exp["training"]
    (val,) = training.validations
    score = ScoreValidation(exp["models"]["embed"], "roxford5k", eval_root,
                            image_size=OPT_SCORE_SIZE)
    training.validations.append(score)

    rec = {"counts": {"val": [], "score": []}, "seconds": {"val": [],
                                                           "score": []},
           "mined_with": [], "state_at_val": []}
    calls = {"K4": [], "K2": [], "K1": []}

    def fingerprint(state):
        with torch.no_grad():
            return float(sum(float(p.double().sum()) for p in
                             state.models["embed"].module.parameters()))

    def counted(tag, fn):
        def run(state, epoch, events):
            before = launches()
            fn(state, epoch, events)
            after = launches()
            rec["counts"][tag].append({k: after[k] - before[k]
                                       for k in after})
            rec["seconds"][tag].append(fn.last_seconds)
        return run
    extract = val.loader.dataset.extract_fn

    def recording_extract(idxs, label="anc-mine"):
        rec["mined_with"].append(fingerprint(extract.holder["state"]))
        return extract(idxs, label)
    recording_extract.holder = extract.holder
    val.loader.dataset.extract_fn = recording_extract
    on_validate = val.on_validate

    def recording_on_validate(state):
        rec["state_at_val"].append(fingerprint(state))
        on_validate(state)
    val.on_validate = recording_on_validate
    training.validations = [counted("val", val), counted("score", score)]
    restore = [_capped_recording(kmasked, "clahe_u8_masked_cuda",
                                 calls["K4"]),
               _capped_recording(kvgg, "conv3x3_same_cuda", calls["K2"]),
               _capped_recording(kclahe, "clahe_u8_cuda", calls["K1"])]
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = training.run(exp["state"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        for r in restore:
            r()
    hist = exp["events"].history
    vloss = [h["metrics"]["val/learning/loss:total"] for h in hist]
    head = "val/validation/roxford5k/"
    score_keys = sorted(k for k in hist[-1]["metrics"] if k.startswith(head))
    out = {"run_s": wall, "val_loss": vloss,
           "best_epoch": exp["events"].metadata.best_epoch(),
           "validation_s": rec["seconds"]["val"],
           "score_s": rec["seconds"]["score"],
           "val_launches": rec["counts"]["val"],
           "score_launches": rec["counts"]["score"],
           "launches": counts, "score_keys": score_keys,
           "map_medium": [h["metrics"].get(head + "score_avg:map_medium")
                          for h in hist]}
    # each epoch's validation mined with that epoch's weights
    mined = rec["mined_with"]
    per = len(mined) // max(len(rec["state_at_val"]), 1)
    mined_ok = per > 0 and all(
        m == rec["state_at_val"][i // per] for i, m in enumerate(mined)) \
        and rec["state_at_val"][0] != rec["state_at_val"][-1]
    logdir = os.path.join(directory, "epochs", "tensorboard")
    (tb_name,) = os.listdir(logdir)
    tb_path = os.path.join(logdir, tb_name)
    n_records = len(read_records(tb_path))
    tb = {}
    for tag, value, step in read_scalar_events(tb_path):
        tb.setdefault(tag, []).append((step, value))
    tb_ok = all(_close([v for _, v in tb.get(k, [])],
                       [h["metrics"][k] for h in hist])
                for k in ("val/learning/loss:total",
                          head + "score_avg:map_medium"))
    out.update(mined_with_epoch_weights=mined_ok, tensorboard_records=n_records,
               tensorboard_scalars_equal_history=tb_ok)
    want_keys = {head + "dataset:eval", head + "score_avg:map_medium",
                 head + "score:ap_medium"}
    if not (all(np.isfinite(vloss)) and len(vloss) == 2 and mined_ok
            and tb_ok and want_keys <= set(score_keys)
            and out["best_epoch"] == int(np.argmin(vloss)) + 1
            and all(c["K4"] and c["K2"] for c in rec["counts"]["val"])
            and all(c["K1"] for c in rec["counts"]["score"])):
        raise AssertionError("fine-tune validations: %s" % json.dumps(out))
    held = check_recorded_k2_k4({"K4": calls["K4"], "K2": calls["K2"]})
    held["K1"] = {"calls": _hold_clahe(calls["K1"], kclahe.clahe_u8_cuda,
                                       clahe_u8_plain)}
    out["held_against_plain"] = held
    del calls
    now = _val_loss_now(val, state)
    (lk, ck), (lp, cp) = now["kernels"], now["plain"]
    out["val_loss_kernels_vs_plain"] = {"kernels": lk, "plain": lp,
                                        "rel": abs(lk - lp) / abs(lp),
                                        "launches": ck,
                                        "mining_launches": now["mining"]}
    if abs(lk - lp) > 1e-2 * abs(lp) or cp["K2"] or cp["K4"] \
            or not (ck["K2"] and now["mining"]["K2"]
                    and now["mining"]["K4"]):
        raise AssertionError("validation loss kernels vs plain: %s"
                             % json.dumps(now))
    del exp, state, training, val, score
    torch.cuda.empty_cache()
    out["triplet_step"] = _triplet_step(dev)
    return out


def _close(got, want, rel=1e-6):
    """Float32 readings `got` of the values `want`."""
    return len(got) == len(want) and all(
        abs(a - b) <= rel * max(abs(b), 1e-30) for a, b in zip(got, want))


def run_training_options(dev):
    """The training options (item 15 of the docstring), at full width:
    (a) HED^N-GAN (train_hedngan.yml, GAN_TRAIN through gan_train_config,
    batch 10 of 256², seeded HED): concat_student, the teacher cache, the
    device scalecrop, SGD with the optimizer rotation, a warm start;
    (b) the fine-tune loop with its validations, TensorBoard and a
    ScoreValidation, and a triplet step. Every launch count of (b) is set
    to 0 just before its run; (a) reaches no kernel."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="opts_", dir=os.environ.get("TMPDIR"))
    out, t_all = {}, time.perf_counter()
    try:
        lists = make_domain_set(tmp)
        reset_launches()
        for name, fn in (("concat_student", _opt_concat),
                         ("teacher_cache", _opt_cache)):
            t0 = time.perf_counter()
            out[name] = fn(dev, tmp, lists)
            out[name]["phase_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["device_scalecrop"], dsc_dir = _opt_dsc(dev, tmp, lists)
        out["device_scalecrop"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["rotation"] = _opt_rotation(dev, tmp, lists)
        out["warm_start"] = _opt_warm_start(dev, tmp, lists, dsc_dir)
        out["rotation"]["phase_s"] = time.perf_counter() - t0
        gan_counts = launches()
        if any(gan_counts.values()):
            raise AssertionError("HED^N-GAN launched %s" % gan_counts)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["finetune"] = _opt_finetune(dev, tmp)
        out["finetune"]["phase_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_all
    # the main path's counts: the fine-tune run with its validations (the
    # GAN parts reach no kernel)
    out["launches"] = dict(out["finetune"]["launches"])
    print("training options (%s): %s" % (card_line(), json.dumps(out)))
    return out


# ---- every network the model registry builds (run_architectures)

ARCH_PRE = "train.1_train_augment."
#: upstream CUT's blur-pool sampling on cut.yml's G and D
ARCH_BLUR = (ARCH_PRE + "network.generator_X.model.no_antialias=false",
             ARCH_PRE + "network.generator_X.model.no_antialias_up=false",
             ARCH_PRE + "network.discriminator_Y.model.no_antialias=false")
#: 8 pairs an epoch (one dispatch chunk), where phase 13's CUT takes 16
ARCH_CUT_SIZE = ARCH_PRE + "data.train.dataset.size=8"
#: the blur-pool generator's taps 4, 8, 12, 16 below a crop: a stride-1
#: conv, one after the first blur, a block, a block
ARCH_BLUR_TAP_STRIDES = (1, 2, 4, 4)
#: pix2pix's unet_256 (num_downs 8, ngf 64, batch norm)
ARCH_UNET = {"architecture": "official_unet_generator", "input_nc": 3,
             "output_nc": 3, "num_downs": 8, "ngf": 64,
             "norm_layer": "batch"}
#: unet_256 takes 256x256 inputs only, and the visual validation's photos
#: are 362 on their longest side: it runs at the validate stage only
ARCH_UNET_OVR = tuple("%snetwork.%s.model=%s" % (ARCH_PRE, g,
                                                 json.dumps(ARCH_UNET))
                      for g in ("generator_X", "generator_Y")) + (
    ARCH_PRE + "learning.validation.visual.frequency=null",)
ARCH_VGG = {"architecture": "cirnet", "cir_architecture": "vgg16",
            "local_whitening": False, "whitening": False}
#: eval.yml's network with each descriptor net of the registry the path
#: had not run
ARCH_EVAL_NETS = {
    "regional_gem": dict(ARCH_VGG, pooling="gem", regional=True),
    "rmac": dict(ARCH_VGG, pooling="rmac", regional=False),
    "attention": {"architecture": "cirnet_attention",
                  "cir_architecture": "vgg16", "pooling": "gem",
                  "attention": {"type": "l2norm"}},
    "edge_filter": {"architecture": "cirnet_inchan",
                    "cir_architecture": "vgg16", "pooling": "gem",
                    "local_whitening": False, "whitening": False,
                    "inputs": {"preprocessing": {"type": "edgefilter"}}},
    "geometric_median": dict(ARCH_VGG, pooling={
        "type": "GeometricMedianWeiszfeld", "iterations": 3}),
}
ARCH_EVAL_CPU_PHOTO = 5        # the 600x800 database photo of make_eval_set
ARCH_FT_STEPS = 3


def _arch_cut(dev, tmp, pth):
    """cut.yml's `train` target through the CLI with ARCH_BLUR, cut as
    FAMILY_CUTS cuts CUT: run_gan_families' checks, the resume of epoch 2
    bit for bit, one step against float64 (taps ARCH_BLUR_TAP_STRIDES
    below the crop). Returns (results, the generator_X_last.ckpt path)."""
    from gandtr_tpu_torch.scenarios import build
    recs, cap = [], {}
    orig_build = _instrumented_gan_builds(recs, snapshot=True)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        _cli(["train", FAMILY_YML["cut"]] + family_overrides("cut", pth)
             + list(ARCH_BLUR) + [ARCH_CUT_SIZE], cap)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = launches()
    finally:
        build.build_gan_experiment = orig_build
    if any(counts.values()):
        raise AssertionError("blur-pool CUT training launched %s" % counts)
    rec, laps = recs[0], {"train_s": time.perf_counter() - t0}
    gan_dir = os.path.join(tmp, "experiments", "gan", "cut")
    kinds = {name: [type(m).__name__ for m in net.module.modules()]
             for name, net in rec["exp"]["models"].items()}
    blurs = {name: (k.count("BlurDownsample"), k.count("BlurUpsample"))
             for name, k in kinds.items()}
    if blurs["generator_X"] != (2, 2) or blurs["discriminator_Y"][0] != 3:
        raise AssertionError("blur steps %s" % blurs)
    t1 = time.perf_counter()
    res = {"seconds": train_s, "launches": counts, "blur_steps": blurs,
           "step_seconds": cap["step_seconds"],
           **_check_family_run("cut", rec, gan_dir), "laps": laps}
    laps["checks_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res["gan"] = _gan_loop_numbers(rec)
    laps["numbers_s"] = time.perf_counter() - t1
    names = list(rec.pop("exp")["models"])
    del rec["start"]
    t1 = time.perf_counter()
    res["resume"] = _family_resume("cut", tmp, rec["copy_dir"], names, pth,
                                   ARCH_BLUR + (ARCH_CUT_SIZE,))
    laps["resume_s"] = time.perf_counter() - t1
    del recs
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    res["parity"] = _family_parity("cut", pth, dev, ARCH_BLUR
                                   + (ARCH_CUT_SIZE,), ARCH_BLUR_TAP_STRIDES)
    laps["parity_s"] = time.perf_counter() - t1
    return res, os.path.join(gan_dir, "epochs", "generator_X_last.ckpt")


def _arch_cyclegan_unet(dev, tmp):
    """cyclegan.yml's `train` target through the CLI with unet_256 for
    both generators (cyclegan_overrides: 2 epochs of 4 steps at batch 1 of
    256², no visual validation): finite losses, no launch, the resume of
    epoch 2 bit for bit, one step at 256² against float64 (normal_p2p as
    shipped)."""
    from gandtr_tpu_torch.scenarios import build
    recs, cap = [], {}
    orig_build = _instrumented_gan_builds(recs)
    argv = ["train", CYCLEGAN_YML] + cyclegan_overrides() + list(
        ARCH_UNET_OVR)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        _cli(argv, cap)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = launches()
        kinds = {type(recs[0]["exp"]["models"][g].module).__name__
                 for g in ("generator_X", "generator_Y")}
        metrics = [float(v) for m in recs[0]["metrics"] for v in m.values()]
        copy_dir = recs[0]["copy_dir"]
    finally:
        build.build_gan_experiment = orig_build
    t1 = time.perf_counter()
    resumed = []
    orig_build = _instrumented_gan_builds(resumed, profile_epoch=None)
    try:
        _cli(argv + ["%slearning.checkpoints.directory=%s"
                     % (ARCH_PRE, json.dumps(copy_dir))], {})
    finally:
        build.build_gan_experiment = orig_build
    laps = {"resume_s": time.perf_counter() - t1}
    if kinds != {"UnetGenerator"} or not metrics or \
            not np.isfinite(metrics).all() or any(counts.values()):
        raise AssertionError("U-Net CycleGAN: %s, launches %s, finite %s"
                             % (kinds, counts, np.isfinite(metrics).all()))
    gan_dir = os.path.join(tmp, "experiments", "gan", "cyclegan")
    for name in CG_NETS:
        _same_tree(*(torch.load(os.path.join(
            d, "epochs", "%s_epoch_02.ckpt" % name), weights_only=True)
            ["model_state"] for d in (gan_dir, copy_dir)), (name,))
    a, b = (torch.load(os.path.join(d, "epochs", "training_epoch_02.pkl"),
                       weights_only=True) for d in (gan_dir, copy_dir))
    for key in ("aux", "events", "rngs", "epoch"):
        _same_tree(a[key], b[key], (key,))
    if len(resumed[0]["epochs"]) != 1:
        raise AssertionError("the resumed U-Net run ran %d epochs"
                             % len(resumed[0]["epochs"]))
    t1 = time.perf_counter()
    out = {"seconds": train_s, "launches": counts,
           "step_seconds": cap["step_seconds"],
           "gan": _gan_loop_numbers(recs[0]),
           "resume_epoch2_bit_equal": True, "laps": laps}
    laps["numbers_s"] = time.perf_counter() - t1
    del recs, resumed
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["parity"] = _cyclegan_parity(dev, ARCH_UNET_OVR, hw=256,
                                     inits=("normal_p2p",))
    laps["parity_s"] = time.perf_counter() - t1
    return out


def _arch_serve(dev, ckpt):
    """The blur-pool generator of `ckpt` (cut.yml's generator_X with
    ARCH_BLUR) through hub.cyclegan in bf16, served by serve_http: rounds
    of N_REQ concurrent 768x1024 `:predict` requests, K3 9 times a batch,
    PNGs byte-equal to the direct call; its bf16 output with K3 within
    max 0.06 / mean 0.01 of the plain-K3 generator's on the 8 photos, and
    the float32 generator on the card within 1e-4 of the CPU port on one
    256x256 image."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.models.layers import BlurDownsample, BlurUpsample
    from gandtr_tpu_torch.serving.export import Servable
    from gandtr_tpu_torch.serving.service import encode_png, serve_http
    gen = hub.cyclegan(pretrained=True, checkpoint=ckpt)
    gen.net.compute_dtype = torch.bfloat16
    kinds = [type(m) for m in gen.net.module.modules()]
    if kinds.count(BlurDownsample) != 2 or kinds.count(BlurUpsample) != 2:
        raise AssertionError("the hub did not build the blur-pool generator")
    images = np.random.RandomState(7).randint(0, 256, (N_REQ,) + HW + (3,),
                                              dtype=np.uint8)
    t0 = time.perf_counter()
    servable = Servable(gen, HW)
    server = serve_http({"blur": servable}, port=0, block=False,
                        max_wait_ms=1000.0)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        reset_launches()
        batches0 = server.models["blur"].batcher.batches
        answers, timing = serve_rounds(base, "blur", images)
        counts = launches()
        batches = server.models["blur"].batcher.batches - batches0
        direct = servable(images)
    finally:
        server.close()
    if counts["K3"] != 9 * batches or batches < 1:
        raise AssertionError("blur-pool generator: K3 %s for %d batches"
                             % (counts, batches))
    for i, (ctype, body) in enumerate(answers):
        if ctype != "image/png" or body != encode_png(direct[i]):
            raise AssertionError("served PNG %d differs from the direct "
                                 "call" % i)
    laps = {"serve_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    x = torch.from_numpy(images).to(dev).float() / 127.5 - 1.0
    mx, mean, nudge = _k3_vs_plain(gen, x)
    laps["k3_vs_plain_s"] = time.perf_counter() - t0
    xs = torch.from_numpy(np.ascontiguousarray(images[:1, :256, :256]))
    xs = xs.float() / 127.5 - 1.0
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = hub.cyclegan(pretrained=True, checkpoint=ckpt, device="cpu")
    with torch.inference_mode():
        d32 = float((gen.net.module(xs.to(dev)).cpu()
                     - cpu.net.module(xs)).abs().max())
    res = {"launches": counts, "batches": batches, **timing,
           "k3_vs_plain_max": mx, "k3_vs_plain_mean": mean,
           "one_level_nudge_max": nudge, "f32_card_vs_cpu_max": d32,
           "laps": laps}
    if mx >= K3_MAX or mean >= K3_MEAN or d32 > 1e-4:
        raise AssertionError("blur-pool generator: %s" % res)
    del gen, servable, x
    torch.cuda.empty_cache()
    return res, images


def _arch_encoder_decoder(dev, images):
    """official_resnet_encoder -> official_resnet_decoder (6 + 6 blocks,
    instance norm, kaiming_p2p weights) in bf16 on the N_REQ photos at
    768x1024: K3 12 times, each block call held against K3's plain version
    on the same inputs by `_k3_on`'s rule (`_k3_held`); the chain's output
    within mean 0.01 of the chain with K3's plain version, and its largest
    distance from the float32 chain on the same weights within
    CHAIN_FACTOR of the plain chain's (`_chain_bound`: twelve chained
    random blocks amplify a block's one-step roundings, so the bound is
    the plain bf16 chain's own distance); the plain chain's change when
    one input value moves by one uint8 level printed beside; ms of each
    (cuda_ms)."""
    from gandtr_tpu_torch.learning.network import WrappedNet
    from gandtr_tpu_torch.models import initialize_model
    from gandtr_tpu_torch.models.init import initialize_weights
    from gandtr_tpu_torch.ops import resblock
    nets = []
    for i, half in enumerate(("encoder", "decoder")):
        m = initialize_model({"architecture": "official_resnet_%s" % half,
                              "n_blocks": 6, "norm_type": "instance"})
        initialize_weights(m, "kaiming_p2p", seed=i)
        nets.append(WrappedNet(module=m.to(dev).eval(),
                               compute_dtype=torch.bfloat16))
    x = torch.from_numpy(images).to(dev).float() / 127.5 - 1.0

    def chain(inp=x):
        return nets[1].apply(nets[0].apply(inp))
    calls, kernel = [], resblock.fused_resblock

    def recording(*args, **kwargs):
        out = kernel(*args, **kwargs)
        calls.append((args, out))
        return out
    with torch.inference_mode():
        chain()
        torch.cuda.synchronize()
        resblock.fused_resblock = recording
        reset_launches()
        try:
            y = chain().float()
            torch.cuda.synchronize()
        finally:
            resblock.fused_resblock = kernel
        counts = launches()
        ms = cuda_ms(chain, reps=3)
        resblock.fused_resblock = resblock.fused_resblock_plain
        try:
            y_plain = chain().float()
            plain_ms = cuda_ms(chain, reps=3)
            x1 = x.clone()
            x1[0, HW[0] // 2, HW[1] // 2, 0] += 2.0 / 255
            nudge = float((chain(x1).float() - y_plain).abs().max())
        finally:
            resblock.fused_resblock = kernel
        f32 = [WrappedNet(module=n.module) for n in nets]
        y_f32 = f32[1].apply(f32[0].apply(x))
    errs = _k3_held(calls)
    del calls
    d = (y - y_plain).abs()
    res = {"launches": counts, "shape": list(y.shape), "ms": ms,
           "plain_ms": plain_ms, "max_abs_err": float(d.max()),
           "mean_abs_err": float(d.mean()), "one_level_nudge_max": nudge,
           "block_calls_max_abs_err": max(e[0] for e in errs),
           "block_calls_mean_abs_err": max(e[1] for e in errs),
           "block_calls_past_bound": sum(e[5]["past_bound"] for e in errs),
           "vs_float32": _chain_bound(y, y_plain, y_f32)}
    if counts["K3"] != 12 or len(errs) != 12 or \
            not all(e[3] for e in errs) or \
            res["block_calls_mean_abs_err"] >= K3_MEAN or \
            res["mean_abs_err"] >= K3_MEAN or \
            not res["vs_float32"]["within"] or \
            not bool(torch.isfinite(y).all()):
        raise AssertionError("encoder -> decoder: %s" % res)
    del nets, f32, x, y, y_plain, y_f32, d
    torch.cuda.empty_cache()
    return res


def _arch_eval(dev, root):
    """eval.yml's validate stage at exact shapes (`shape_bucket: null`,
    K1) on make_eval_set's photos, at image size 1024 with 3 scales and
    the seeded Lw, for each ARCH_EVAL_NETS net (seeded weights), every
    launch count set to 0 just before each: K1 once a photo and no K4,
    descriptors finite and of unit norm, the mAPs and images/s printed,
    and one photo's descriptor within 1e-4 of the CPU port."""
    import pickle
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.scenarios import validate_stage
    db_paths = make_eval_set(root)
    lw_path = os.path.join(root, "lw.pkl")
    with open(lw_path, "wb") as f:
        pickle.dump(seeded_lw(), f)
    n_img = EVAL_DB + EVAL_Q
    out, total = {}, dict.fromkeys(("K1", "K2", "K3", "K4"), 0)
    for name, model in ARCH_EVAL_NETS.items():
        params = eval_params(root, lw_path, None)
        params["network"]["model"] = dict(model)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        (res,), rec = _recorded(validate_stage, lambda: validate_stage
                                .validate(params, None))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        metrics, _, vecs, qvecs = rec[0]
        for v in (vecs, qvecs):
            norms = np.linalg.norm(v, axis=0)
            if not np.isfinite(v).all() or v.shape[0] != 512 or \
                    np.abs(norms - 1).max() > 1e-5:
                raise AssertionError("%s: descriptors %s %s"
                                     % (name, v.shape, norms))
        if counts["K1"] != n_img or counts["K4"] != 0:
            raise AssertionError("%s launched %s for %d photos"
                                 % (name, counts, n_img))
        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.perf_counter()
        cpu = validate_stage.build_eval(params, torch.device("cpu"))
        photo = db_paths[ARCH_EVAL_CPU_PHOTO]
        cpu_vec = R.extract_vectors(cpu["extractor"], [photo], 1024,
                                    cpu["transform"])
        cpu_s = time.perf_counter() - t0
        d_cpu = float(np.abs(cpu_vec[:, 0]
                             - vecs[:, ARCH_EVAL_CPU_PHOTO]).max())
        if d_cpu > 1e-4:
            raise AssertionError("%s card vs CPU port: %g" % (name, d_cpu))
        out[name] = {"launches": counts, "wall_s": wall,
                     "images_per_s": n_img / wall, "mAP": metrics,
                     "card_vs_cpu": d_cpu, "cpu_s": cpu_s}
        for k, v in counts.items():
            total[k] += v
        print("architectures eval %s (exact, 1024, 3 scales): %s"
              % (name, json.dumps(out[name])))
    out["launches"] = total
    return out


def _arch_finetune(dev):
    """finetune.yml's tuple step (T=5, S=7, bf16 embed) with a
    cirnet_inchan embed (the edge filter before GeM-VGG16): a warm-up step,
    then ARCH_FT_STEPS timed steps with every launch count set to 0 just
    before them: finite losses, K2 10 and K4 5 times a step, the edge
    filter's p and tau moved; then, at T=2, the step with K2 and K4
    swapped for their plain versions: the loss within 1% and tuple 0's
    descriptors within 5e-3."""
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    cfg = finetune_config()
    cfg["network"]["embed"]["model"] = dict(
        ARCH_EVAL_NETS["edge_filter"], pretrained=False, regional=False)
    exp = build_finetune_experiment(cfg, device=dev)
    pre = exp["models"]["embed"].module.preprocessing
    start = (float(pre.p.detach()), float(pre.tau.detach()))
    batch = finetune_batch(dev)
    state, _ = exp["step"](exp["state"], *batch)
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(ARCH_FT_STEPS):
        state, m = exp["step"](state, *batch)
        losses.append(m["total"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    losses = [float(v) for v in losses]
    end = (float(pre.p.detach()), float(pre.tau.detach()))
    res = {"ms_per_step": 1e3 * secs / ARCH_FT_STEPS, "losses": losses,
           "launches": counts, "p_tau_start": start, "p_tau_end": end}
    if not np.isfinite(losses).all() or start[0] == end[0] or \
            start[1] == end[1] or counts["K2"] != 2 * FT_T * ARCH_FT_STEPS \
            or counts["K4"] != FT_T * ARCH_FT_STEPS:
        raise AssertionError("cirnet_inchan fine-tune: %s" % res)
    del exp, state, batch
    torch.cuda.empty_cache()
    small = finetune_batch(dev, T=2, seed=1)
    got = {}
    for name in ("kernels", "plain"):
        restore = _plain_k2_k4() if name == "plain" else (lambda: None)
        try:
            exp = build_finetune_experiment(cfg, device=dev)
            x, masks = exp["stage"](small[0], small[1])
            desc = _descriptors(exp, x, masks, small[3])
            _, m = exp["step"](exp["state"], *small)
            got[name] = (float(m["total"]), desc)
        finally:
            restore()
    (lk, dk), (lp, dp) = got["kernels"], got["plain"]
    res["plain_loss_rel"] = abs(lk - lp) / abs(lp)
    res["plain_desc_max"] = float((dk - dp).abs().max())
    if res["plain_loss_rel"] > 1e-2 or res["plain_desc_max"] > 5e-3:
        raise AssertionError("cirnet_inchan kernels vs plain: %s" % res)
    torch.cuda.empty_cache()
    return res


def run_architectures(dev):
    """Every network the registry builds that no earlier phase ran (the
    module docstring's item 16), each part with every launch count set to
    0 just before it and read just after: (b) training, blur-pool CUT and
    the U-Net CycleGAN through the CLI; (a) serving, the blur-pool
    generator from (b)'s checkpoint and the encoder -> decoder chain; (c)
    the eval of five descriptor nets at exact shapes; (d) a cirnet_inchan
    fine-tune step."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="arch_", dir=os.environ.get("TMPDIR"))
    old_root = os.environ.get("GANDTR_ROOT")
    os.environ["GANDTR_ROOT"] = tmp
    out, t_all = {}, time.perf_counter()
    try:
        make_family_data(tmp)
        pth = seeded_detectors(tmp)
        t0 = time.perf_counter()
        out["cut_blur"], ckpt = _arch_cut(dev, tmp, pth)
        out["cut_blur"]["phase_s"] = time.perf_counter() - t0
        print("architectures: blur-pool CUT: %s" % json.dumps(out["cut_blur"]))
        t0 = time.perf_counter()
        out["cyclegan_unet"] = _arch_cyclegan_unet(dev, tmp)
        out["cyclegan_unet"]["phase_s"] = time.perf_counter() - t0
        print("architectures: U-Net CycleGAN: %s"
              % json.dumps(out["cyclegan_unet"]))
        t0 = time.perf_counter()
        out["serve_blur"], images = _arch_serve(dev, ckpt)
        t1 = time.perf_counter()
        out["encoder_decoder"] = _arch_encoder_decoder(dev, images)
        out["encoder_decoder"]["phase_s"] = time.perf_counter() - t1
        out["serve_blur"]["phase_s"] = time.perf_counter() - t0
        print("architectures: blur-pool generator served: %s; encoder -> "
              "decoder: %s" % (json.dumps(out["serve_blur"]),
                               json.dumps(out["encoder_decoder"])))
        t0 = time.perf_counter()
        out["eval"] = _arch_eval(dev, os.path.join(tmp, "eval_set"))
        out["eval"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["finetune"] = _arch_finetune(dev)
        out["finetune"]["phase_s"] = time.perf_counter() - t0
        print("architectures: cirnet_inchan fine-tune: %s"
              % json.dumps(out["finetune"]))
    finally:
        if old_root is None:
            os.environ.pop("GANDTR_ROOT", None)
        else:
            os.environ["GANDTR_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = {k: out["serve_blur"]["launches"][k]
                       + out["encoder_decoder"]["launches"][k]
                       + out["eval"]["launches"][k]
                       + out["finetune"]["launches"][k]
                       for k in ("K1", "K2", "K3", "K4")}
    out["phase_s"] = time.perf_counter() - t_all
    print("architectures (%s): %.1f s, launches %s"
          % (card_line(), out["phase_s"], json.dumps(out["launches"])))
    return out


# ---- the data side: other colorspaces, the tuple datasets, image sinks

DATA_SPACES = ("luv", "lsh", "hsv")
DATA_FT_STEPS = 4        # fine-tune steps with the kernels, then plain
DATA_TUPLES = 40         # rows of the HED^N-GAN tuple pickle (3 photos each)
DATA_TUPLE_HW = (448, 512)    # over ceil(256 / 0.6) = 427 a side
DATA_CG_TUPLES = 4       # CycleGAN rows (one epoch)
DATA_CG_HW = (288, 352)
DATA_OUT_SHAPES = [(250, 333), (301, 226), (250, 333), (198, 402)]
DATA_TIE = 1e-4          # a truncation tie: float64 value this near a level
DATA_ON_LEVEL = 1e-2     # most of a generator's values at a tie, for (d)
DATA_PNG_SHARE = 1e-3    # most of (d)'s PNG values off the CPU port's


def _data_eval(dev, root):
    """(a) eval.yml's validate stage with the descriptor chain `pil2np |
    apply_clahe:1.0:8:<space> | totensor | normalize` for each of
    DATA_SPACES, bucketed (K4) and exact (K1), through validate_modes and
    compare_modes; 2 photos within 1e-4 of the CPU port; every K1 and K4
    call of the counted runs bit-equal to its plain version."""
    import pickle
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import (clahe_u8_masked_plain,
                                            clahe_u8_plain)
    from gandtr_tpu_torch.scenarios import validate_stage
    db_paths = make_eval_set(root)
    lw_path = os.path.join(root, "lw.pkl")
    with open(lw_path, "wb") as f:
        pickle.dump(seeded_lw(), f)
    n_img = EVAL_DB + EVAL_Q
    out, total = {}, dict.fromkeys(("K1", "K2", "K3", "K4"), 0)
    for space in DATA_SPACES:
        chain = "pil2np | apply_clahe:1.0:8:%s | totensor | normalize" % space

        def params_for(bucket):
            params = eval_params(root, lw_path, bucket)
            params["data"]["transforms"] = chain
            return params

        calls = {"K4": [], "K1": []}
        modes = validate_modes(dev, params_for, n_img, 512, calls,
                               label="data_side eval %s" % space)
        d_be = compare_modes(modes, EVAL_Q, label="data_side eval %s" % space)
        held = {"K1": _hold_clahe(calls["K1"], kclahe.clahe_u8_cuda,
                                  clahe_u8_plain),
                "K4": _hold_clahe(calls["K4"], kmasked.clahe_u8_masked_cuda,
                                  clahe_u8_masked_plain)}
        torch.set_num_threads(os.cpu_count() or 1)
        cpu = validate_stage.build_eval(params_for(64), torch.device("cpu"))
        cpu_vecs = R.extract_vectors(cpu["extractor"], db_paths[:2], 1024,
                                     cpu["transform"])
        d_cpu = float(np.abs(cpu_vecs - modes["bucketed"]["vecs"][:, :2])
                      .max())
        if d_cpu > 1e-4:
            raise AssertionError("data_side eval %s card vs CPU port: %g"
                                 % (space, d_cpu))
        out[space] = {
            "images_per_s": {m: modes[m]["images_per_s"] for m in modes},
            "launches": {m: modes[m]["launches"] for m in modes},
            "bucketed_vs_exact": d_be, "card_vs_cpu": d_cpu,
            "held_bit_equal": held}
        for m in modes:
            for k, v in modes[m]["launches"].items():
                total[k] += v
        print("data_side eval %s: %s" % (space, json.dumps(out[space])))
    out["launches"] = total
    return out


def _data_finetune(dev):
    """(b) finetune.yml's tuple step (T=5, S=7, 364², bf16 embed) with its
    augment wrappers' `clahepost:...:1.0:8:luv`: a warm-up step, then
    DATA_FT_STEPS steps with every launch count set to 0 just before them
    (K2 10 and K4 5 a step, each K4 call held bit for bit against its
    plain version), then the same steps from the same weights with K2 and
    K4 swapped for their plain versions: each step's loss within 1% and
    tuple 0's descriptors within 5e-3 (_arch_finetune's rule)."""
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    cfg = finetune_config()
    aug = cfg["network"]["augment"]["runtime"]
    aug["wrappers"] = aug["wrappers"].replace(
        "clahepost:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:1.0,",
        "clahepost:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:1.0:8:luv,")
    if ":8:luv" not in aug["wrappers"]:
        raise AssertionError("no clahepost in %r" % aug["wrappers"])
    batch = finetune_batch(dev)
    res, runs = {}, {}
    for name in ("kernels", "plain"):
        restore = _plain_k2_k4() if name == "plain" else (lambda: None)
        calls = []
        try:
            exp = build_finetune_experiment(cfg, device=dev)
            x, masks = exp["stage"](batch[0], batch[1])
            desc = _descriptors(exp, x, masks, batch[3])
            state, _ = exp["step"](exp["state"], *batch)
            torch.cuda.synchronize()
            if name == "kernels":
                put_back = _capped_recording(kmasked, "clahe_u8_masked_cuda",
                                             calls, cap=DATA_FT_STEPS * FT_T)
            reset_launches()
            losses = []
            t0 = time.perf_counter()
            for _ in range(DATA_FT_STEPS):
                state, m = exp["step"](state, *batch)
                losses.append(m["total"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launches()
            if name == "kernels":
                put_back()
        finally:
            restore()
        runs[name] = ([float(v) for v in losses], desc)
        res[name] = {"ms_per_step": 1e3 * secs / DATA_FT_STEPS,
                     "losses": runs[name][0], "launches": counts}
        if name == "kernels":
            res["k4_calls_held"] = _hold_clahe(
                calls, kmasked.clahe_u8_masked_cuda, clahe_u8_masked_plain)
        del exp, state, x, masks
        torch.cuda.empty_cache()
    (lk, dk), (lp, dp) = runs["kernels"], runs["plain"]
    res["plain_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    res["plain_desc_max"] = float((dk - dp).abs().max())
    k = res["kernels"]["launches"]
    if not np.isfinite(lk).all() or k["K2"] != 2 * FT_T * DATA_FT_STEPS \
            or k["K4"] != FT_T * DATA_FT_STEPS \
            or res["plain_loss_rel"] > 1e-2 or res["plain_desc_max"] > 5e-3:
        raise AssertionError("luv clahepost fine-tune: %s" % res)
    res["launches"] = k
    return res


def make_tuple_pickle(root, rows, hw, seed=0):
    """`rows` rows of 3 seeded JPEGs of `hw` (day, night, night) under
    <root>/tuples and their names as a tuple pickle {"train": rows};
    returns the pickle's path."""
    import pickle
    rs = np.random.RandomState(seed)
    ims = os.path.join(root, "tuples")
    os.makedirs(ims)
    names = []
    for r in range(rows):
        row = ["t%02d_%d" % (r, c) for c in range(3)]
        for c, name in enumerate(row):
            _photo(rs, *hw, dark=c > 0).save(os.path.join(ims, name + ".jpg"),
                                             quality=90)
        names.append(row)
    path = os.path.join(root, "tuples.pkl")
    with open(path, "wb") as f:
        pickle.dump({"train": names}, f)
    return path


def _tuple_data(cfg, pkl, root, idx, chain, batch, shuffle):
    """cfg's data.train on the tuple pickle: `idx` of each row."""
    train = cfg["data"]["train"]
    train["dataset"] = {"name": "RandomImageTuple" if "any" in idx
                        else "PregeneratedImageTuple",
                        "dataset": pkl, "data_key": "train",
                        "image_dir": os.path.join(root, "tuples"),
                        "idx": idx}
    train["transforms"] = chain
    train["loader"] = {"batch_size": batch, "shuffle": shuffle}


def _train_recorded(cfg, dev, per_step=None):
    """The train stage on `cfg` with the build instrumented
    (_instrumented_gan_builds, epoch 2 profiled); `per_step(exp)` wraps
    the loop's step after that. Returns the record."""
    from gandtr_tpu_torch.scenarios import build
    from gandtr_tpu_torch.scenarios.train_stage import train
    recs = []
    orig = _instrumented_gan_builds(recs)
    inst = build.build_gan_experiment

    def both(*args, **kwargs):
        exp = inst(*args, **kwargs)
        if per_step is not None:
            per_step(exp)
        return exp
    build.build_gan_experiment = both
    try:
        train(cfg, (), device=dev)
    finally:
        build.build_gan_experiment = orig
    return recs[0]


def _data_hedngan(dev, root):
    """(c) train_hedngan.yml through the train stage on a deterministic
    tuple pipeline: PregeneratedImageTuple (idx 0_1) over DATA_TUPLES rows,
    `pil2np | centerscalecrop:256_256:0.6 | totensor | normalize`, batch
    10, the loader unshuffled, 2 epochs, visual validation off; with
    `cache_teacher_targets` and without. Epoch 1 misses on every batch and
    epoch 2 hits on every one; the two runs end bit-equal (nets and
    Adams); each run, its launch counts set to 0 just before it and read
    just after, launches no kernel (float32 training reaches none). Prints
    hit and miss ms (each step synchronised) and the cached run's busy
    share over epoch 2."""
    pkl = make_tuple_pickle(root, DATA_TUPLES, DATA_TUPLE_HW)
    chain = "pil2np | centerscalecrop:256_256:0.6 | totensor | normalize"
    recs, order, counts = {}, [], {}
    for tag, cache in (("cached", True), ("plain", False)):
        # the domain lists are replaced by the tuple pickle
        cfg = gan_train_config(os.path.join(root, tag), ("", ""))
        _tuple_data(cfg, pkl, root, "0_1", chain, 10, False)
        cfg["learning"]["validation"]["visual"]["frequency"] = 0
        cfg["learning"]["training"]["epoch_iteration"][
            "cache_teacher_targets"] = cache
        times = {"hit": [], "miss": []}

        def per_step(exp):
            if not cache:
                return
            loop, step = exp["training"].loop, exp["step"]
            inner = loop.step_fn

            def timed(state, *args):
                hits = step.hits
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(state, *args)
                torch.cuda.synchronize()
                kind = "hit" if step.hits > hits else "miss"
                times[kind].append(1e3 * (time.perf_counter() - t0))
                order.append(kind)
                return out
            loop.step_fn = timed
        reset_launches()
        recs[tag] = _train_recorded(cfg, dev, per_step)
        counts[tag] = launches()
        if cache:
            recs["times"] = times
    a, b = recs["cached"]["exp"], recs["plain"]["exp"]
    diff = _nets_differ(a, b)
    for name, opt in b["state"].optimizers.items():
        want = opt.state_dict()["state"]
        got = a["state"].optimizers[name].state_dict()["state"]
        diff += ["%s moment %s.%s" % (name, i, k) for i, s in want.items()
                 for k, v in s.items() if not torch.equal(v, got[i][k])]
    steps = DATA_TUPLES // 10
    numbers = _gan_loop_numbers(recs["cached"])
    out = {"order": order, "bit_equal_to_uncached": not diff,
           "miss_ms": float(np.median(recs["times"]["miss"])),
           "hit_ms": float(np.median(recs["times"]["hit"])),
           "epoch2_busy_share": numbers["epoch2_steps_busy_share"],
           "loop_ms_per_step_epoch2": numbers["loop_ms_per_step_epoch2"],
           "plain_loop_ms_per_step_epoch2": _gan_loop_numbers(
               recs["plain"])["loop_ms_per_step_epoch2"],
           "launches_by_run": counts,
           "launches": {k: sum(c[k] for c in counts.values())
                        for k in ("K1", "K2", "K3", "K4")}}
    if diff or order != ["miss"] * steps + ["hit"] * steps \
            or any(out["launches"].values()):
        raise AssertionError("tuple-pipeline teacher cache: %s; differs: %s"
                             % (json.dumps(out), diff[:8]))
    return out


def _decoded(directory):
    from PIL import Image
    return {f: np.asarray(Image.open(os.path.join(directory, f)))
            for f in sorted(os.listdir(directory))}


def _ties_only(post, host, host_y, ms):
    """device_postprocess's PNGs (float32 on the card) against the host
    sink's (float64) on the same outputs: one level at most, and only at
    a truncation tie, where the float64 value * 255 lies within
    DATA_TIE of an integer (float32's roundings of y * std + mean and of
    the * 255 move it by less: about 3e-5 at std = mean = 0.5). Returns
    (most levels, share of values that differ, share of the unclipped
    values that sit at a tie: the rule has force only where it is
    small)."""
    worst, share, on_level = 0, 0.0, 0.0
    for k, want in host.items():
        got = post[k].astype(int)
        v = np.clip((host_y[k].astype(np.float64) * np.asarray(ms[1])
                     + np.asarray(ms[0])) * 255, 0, 255)
        if got.shape != want.shape:
            raise AssertionError("device_postprocess %s: %s" % (k,
                                                                got.shape))
        d = got != want
        tie = np.abs(v - np.round(v)) <= DATA_TIE
        levels = int(np.abs(got - want).max())
        off = int((d & ~tie).sum())
        if levels > 1 or off:
            raise AssertionError(
                "device_postprocess %s: %d levels, %d values differ, %d "
                "of them off a tie" % (k, levels, int(d.sum()), off))
        inside = (v > 0) & (v < 255)
        worst, share = max(worst, levels), max(share, float(d.mean()))
        on_level = max(on_level, float(tie[inside].mean()))
    return worst, share, on_level


def _png_levels(card, cpu, card_y, cpu_y, ref, sink, ms):
    """(d)'s luv PNGs of one photo, the card's against the CPU port's: at
    most DATA_PNG_SHARE of the values differ, and where one differs by
    more than a level the sink's undo is that ill-conditioned there: its
    levels over the cube of half-side eps about the float64 output (eps
    the largest |output - float64| of the card's and the CPU's on the
    photo; its 27 corners, edge and face centres) span at least that
    difference less one. Returns the numbers, with the float64 L
    (cv2's 0-100) of those values."""
    d = np.abs(card.astype(int) - cpu)
    eps = float(max(np.abs(card_y - ref).max(), np.abs(cpu_y - ref).max()))
    iy, ix, ic = np.nonzero(d > 1)
    out = {"levels": int(d.max()), "share": float((d > 0).mean()),
           "over_one": int(len(iy)), "eps": eps}
    if len(iy):
        grid = np.stack(np.meshgrid(*[(-1.0, 0.0, 1.0)] * 3,
                                    indexing="ij"), -1).reshape(27, 3)
        pts = ref[iy, ix][:, None, :3] + eps * grid
        lv = sink.to_uint8(pts.reshape(-1, 1, 3)).reshape(-1, 27, 3)
        lv = lv.astype(int)[np.arange(len(ic)), :, ic]
        spread = lv.max(1) - lv.min(1)
        L = (ref[iy, ix, 0] * ms[1][0] + ms[0][0]) * 100
        out.update(min_spread=int(spread.min()),
                   unexplained=int((d[iy, ix, ic] > spread + 1).sum()),
                   L_range=[float(L.min()), float(L.max())])
    if out["share"] > DATA_PNG_SHARE or out.get("unexplained"):
        raise AssertionError("luv PNG card vs CPU port: %s" % out)
    return out


def _data_cyclegan(dev, root):
    """(d) train_cyclegan.yml through the train stage (full width, batch
    1) on RandomImageTuple (idx 0_any) over DATA_CG_TUPLES rows with
    `pil2np | mirror | random_crop:256 | gaussian_noise:0.01 | tospace:luv
    | totensor | normalize`, 2 epochs, visual validation off; then the
    infer stage's image output of the trained generator_X on photos of
    DATA_OUT_SHAPES (no side a multiple of 4) through
    `reflectpad_divisible:4`, with `tospace:luv` in its transforms (the
    sink undoes luv), on the card and on the CPU: PNGs of the inputs'
    shapes; the outputs the sink took (normalized luv) within twice the
    CPU float32's distance from a float64 CPU forward (L2, relative, on
    every photo: the rule of the CycleGAN step, PERF.md §2, for this
    normal_p2p generator); the PNGs held to the CPU port's by
    _png_levels. Then plain RGB (`pil2np | totensor | normalize`: the
    sink's device_postprocess takes plain RGB only, as in the JAX
    package) with `device_postprocess: true` against the host sink, for
    the trained generator and for one of seeded He-normal weights whose
    outputs do not sit on levels (at most DATA_ON_LEVEL of its unclipped
    values at a tie): a level at most, and only at float32 against
    float64 truncation ties (_ties_only). The training and every run on
    the card have their launch counts set to 0 just before and read just
    after, and launch no kernel (float32 reaches none)."""
    from gandtr_tpu_torch.data.datasets import imread
    from gandtr_tpu_torch.data.transforms import initialize_transforms
    from gandtr_tpu_torch.scenarios import infer_stage
    from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
    pkl = make_tuple_pickle(os.path.join(root, "cg"), DATA_CG_TUPLES,
                            DATA_CG_HW, seed=1)
    cfg = load_yaml_scenario([CYCLEGAN_YML] + cyclegan_overrides())
    cfg = cfg["train"]["1_train_augment"]
    cfg["learning"]["checkpoints"]["directory"] = os.path.join(root, "cg_exp")
    cfg["learning"]["validation"]["visual"]["frequency"] = 0
    _tuple_data(cfg, pkl, os.path.join(root, "cg"), "0_any",
                "pil2np | mirror | random_crop:256 | gaussian_noise:0.01 | "
                "tospace:luv | totensor | normalize", 1, True)
    counts = {}
    t0 = time.perf_counter()
    reset_launches()
    rec = _train_recorded(cfg, dev)
    counts["train"] = launches()
    train_s = time.perf_counter() - t0
    numbers = _gan_loop_numbers(rec)
    if len(rec["metrics"]) != 2 * DATA_CG_TUPLES or not all(
            np.isfinite(float(v)) for m in rec["metrics"] for v in m.values()):
        raise AssertionError("luv CycleGAN: %d steps, %s"
                             % (len(rec["metrics"]), rec["metrics"][-1:]))
    ckpt = os.path.join(root, "cg_exp", "epochs", "generator_X_best.ckpt")
    if not os.path.isfile(ckpt):
        raise AssertionError("no %s among %s" % (ckpt, sorted(os.listdir(
            os.path.dirname(ckpt)))))
    rs = np.random.RandomState(2)
    ims = os.path.join(root, "out_ims")
    os.makedirs(ims)
    names = []
    for i, (h, w) in enumerate(DATA_OUT_SHAPES):
        names.append("o%d.png" % i)
        _photo(rs, h, w).save(os.path.join(ims, names[-1]))
    ms = [[0.5] * 3, [0.5] * 3]
    net_cfg = {"type": "SingleNetwork", "path": ckpt,
               "runtime": {"wrappers": "reflectpad_divisible:4", "data": {}}}

    def run(tag, where, chain, post=False, net=net_cfg):
        """The image output into <root>/<tag>: (decoded PNGs, seconds,
        the float outputs the sink took)."""
        params = {"network": dict(net),
                  "data": {"image_dir": ims, "transforms": chain,
                           "mean_std": ms, "device_postprocess": post,
                           "loader": {"batch_size": 2}},
                  "output": {"type": "image",
                             "directory": os.path.join(root, tag)}}
        floats, add = {}, infer_stage.RgbImageSaver.add

        def recording(self, name, image_hwc, input_hwc=None):
            floats[name] = np.array(image_hwc)
            return add(self, name, image_hwc, input_hwc)
        infer_stage.RgbImageSaver.add = recording
        reset_launches()
        t0 = time.perf_counter()
        try:
            infer_stage.infer(params, (names,), device=where)
        finally:
            infer_stage.RgbImageSaver.add = add
        if where != "cpu":
            counts[tag] = launches()
        return (_decoded(os.path.join(root, tag)), time.perf_counter() - t0,
                floats)

    luv = "pil2np | tospace:luv | totensor | normalize"
    rgb = "pil2np | totensor | normalize"
    card, card_s, card_y = run("luv_card", dev, luv)
    for name, (h, w) in zip(names, DATA_OUT_SHAPES):
        if card[name].shape != (h, w, 3) or card[name].dtype != np.uint8:
            raise AssertionError("luv output %s: %s" % (name,
                                                        card[name].shape))
    torch.set_num_threads(os.cpu_count() or 1)
    cpu, cpu_s, cpu_y = run("luv_cpu", "cpu", luv)
    f64 = infer_stage._load_network(net_cfg, "cpu")
    f64.module.double()
    tf = initialize_transforms(luv, ms)
    sink = infer_stage.RgbImageSaver(os.path.join(root, "luv_probe"), ms,
                                     transforms=luv)
    rel, levels = {}, {}
    try:
        for name in names:
            x = tf(imread(os.path.join(ims, name)))[None].double()
            with torch.no_grad():
                ref = f64.apply(x, train=False)[0].numpy()
            rel[name] = {k: float(np.linalg.norm(y[name] - ref)
                                  / np.linalg.norm(ref))
                         for k, y in (("card", card_y), ("cpu", cpu_y))}
            levels[name] = _png_levels(card[name], cpu[name], card_y[name],
                                       cpu_y[name], ref, sink, ms)
    finally:
        sink.close()
    seeded = {"type": "SingleNetwork", "path": None,
              "model": dict(f64.loaded_model_cfg),
              "runtime": {"wrappers": "reflectpad_divisible:4", "data": {}}}
    del f64
    vs_host = {}
    for which, net in (("trained", net_cfg), ("seeded", seeded)):
        host, _, host_y = run("rgb_host_" + which, dev, rgb, net=net)
        post, _, _ = run("rgb_post_" + which, dev, rgb, post=True, net=net)
        vs_host[which] = _ties_only(post, host, host_y, ms)
    out = {"train_s": train_s, "steps": len(rec["metrics"]),
           "loop_ms_per_step_epoch2": numbers["loop_ms_per_step_epoch2"],
           "epoch2_busy_share": numbers["epoch2_steps_busy_share"],
           "output_s": card_s, "output_cpu_s": cpu_s,
           "luv_outputs_rel_to_float64": rel,
           "luv_png_card_vs_cpu": levels,
           "device_postprocess_vs_host_levels_share_on_level": vs_host,
           "launches_by_run": counts,
           "launches": {k: sum(c[k] for c in counts.values())
                        for k in ("K1", "K2", "K3", "K4")}}
    far = [n for n, r in rel.items() if r["card"] > 2 * r["cpu"]]
    if far or any(out["launches"].values()) \
            or vs_host["seeded"][2] > DATA_ON_LEVEL:
        raise AssertionError("luv output past twice the CPU's distance "
                             "from float64 (%s), launches, or a seeded "
                             "generator on levels: %s"
                             % (far, json.dumps(out)))
    return out


def run_data_side(dev):
    """The data side (the module docstring's item 17), in a temp dir set as
    $GANDTR_ROOT, each part with every launch count set to 0 just before
    it and read just after: (a) _data_eval, (b) _data_finetune, (c)
    _data_hedngan, (d) _data_cyclegan. Prints each part and the phase's
    seconds."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="data_", dir=os.environ.get("TMPDIR"))
    old_root = os.environ.get("GANDTR_ROOT")
    os.environ["GANDTR_ROOT"] = tmp
    out, t_all = {}, time.perf_counter()
    try:
        for key, fn in (
                ("eval", lambda: _data_eval(dev, os.path.join(tmp, "eval"))),
                ("finetune", lambda: _data_finetune(dev)),
                ("hedngan_tuples", lambda: _data_hedngan(dev, tmp)),
                ("cyclegan_luv", lambda: _data_cyclegan(dev, tmp))):
            t0 = time.perf_counter()
            out[key] = fn()
            out[key]["phase_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            print("data_side %s (%s): %s" % (key, card_line(),
                                             json.dumps(out[key])))
    finally:
        if old_root is None:
            os.environ.pop("GANDTR_ROOT", None)
        else:
            os.environ["GANDTR_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("eval", "finetune", "hedngan_tuples",
                               "cyclegan_luv"))
                       for k in ("K1", "K2", "K3", "K4")}
    out["phase_s"] = time.perf_counter() - t_all
    print("data_side (%s): %.1f s, launches %s"
          % (card_line(), out["phase_s"], json.dumps(out["launches"])))
    return out


# ---- the model side: local features, the VLAD grouping layers, multi-head

LM_PHOTOS = 40           # 5 batches of N_REQ seeded 768x1024 photos
LM_BOOK_PHOTOS = 32      # the photos whose local features make the codebook
LM_TUPLE = 7             # the next photos: query, positive, 5 negatives
LM_BOOK = "64k"
LM_TOP = "8k"
LM_TOP_FEW = "2k"
LM_BIG = "512k"
LM_SOFT_K = 1024
LM_BATCH_K = 256
LM_ITERATIONS = 10
LM_SAMPLE = 4096         # points whose last k-means assignment is recomputed
LM_GAP = 1e-4            # float64 relative gap under which an argmin may flip
LM_TOL = 1e-5            # descriptors (and gradients, relative) vs float64
LM_EXTRA_GIB = 2.0       # the 512k assignment's peak beyond its inputs
LM_HARD = ("res", "top", "uniform", "l2norm", "maxass")
LM_SOFT = ("res", "all", "softmax-20", "l2norm", "avgass")
# per-batch clusters are the means of the very features they group, so a
# residual summed over a cluster cancels to rounding noise: BatchClustering
# sums the features themselves
LM_BATCH = ("iden", "top", "uniform", "l2norm", "maxass")
# the C.2 rule: a bf16 chain with K3 stays within this factor of the plain
# bf16 chain's largest distance from the float32 chain on the same weights
CHAIN_FACTOR = 2.0
MH_GROUPS = {"base": {"lr": 0.1}, "night": {"lr": 10.0, "weight_decay": 0.0}}
MH_ADAM = {"algorithm": "adam", "lr": 4e-7, "weight_decay": 0.01}
MH_STEP_HW = 64          # the Adam step's crops (the CPU repeats it)


class _FeatureMaps(torch.nn.Module):
    """A GeM net's backbone feature maps (N, h, w, 512), channels last."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net._features(x, None)[0]


def _flat_local(local, i):
    """Image i's local features over every scale, L2-normalized (as VLAD
    codebooks take them), and their attentions: ((n, D), (n, 1))."""
    from gandtr_tpu_torch.ops.norm import l2n
    f = torch.cat([s[0][i].reshape(-1, s[0].shape[-1]) for s in local])
    a = torch.cat([s[1][i].reshape(-1, 1) for s in local])
    return l2n(f), a


def _lm_local(dev):
    """(a): GlobalLocalModule on the hub's GeM-VGG16 (float32, seeded)
    through its served preprocessing (LAB CLAHE, K1) over LM_PHOTOS seeded
    photos, 5 scales; forward_global against the net's own single-scale
    descriptor."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.data.transforms import split_device_transform
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.learning.network import (GlobalLocalModule,
                                                   WrappedNet)
    model = hub.gem_vgg16_hedngan(pretrained=False, device=dev)
    dp = model.net.data_params
    _, pre = split_device_transform(dp["transforms"], dp["mean_std"])
    net = model.net.module
    gl = GlobalLocalModule(WrappedNet(module=_FeatureMaps(net).eval()))
    rs = np.random.RandomState(17)
    photos = [np.asarray(_photo(rs, *HW)) for _ in range(LM_PHOTOS)]
    calls, images, first = [], [], None
    restore = _recording_calls(kclahe, "clahe_u8_cuda", calls)
    reset_launches()
    t0 = time.perf_counter()
    try:
        # no_grad, not inference_mode: (e) differentiates these features
        with torch.no_grad():
            for b in range(0, LM_PHOTOS, N_REQ):
                xu = torch.from_numpy(np.stack(photos[b:b + N_REQ])).to(dev)
                xn = pre(xu.to(torch.float32) / 255.0)
                local = gl.forward_local(xn)
                images += [_flat_local(local, i) for i in range(xn.shape[0])]
                if first is None:
                    torch.cuda.synchronize()
                    first, x0 = time.perf_counter(), xn
            torch.cuda.synchronize()
    finally:
        restore()
    seconds = time.perf_counter() - first
    counts = launches()
    with torch.no_grad():
        glob, single = gl.forward_global(x0), net(x0)
    held = _held_k1(calls)
    d_global = float((glob - single).abs().max())
    scales = [list(s[0].shape[1:3]) for s in local]
    res = {"launches": counts, "k1_calls_held": len(calls),
           "k1_shapes": held, "scales_hw": scales,
           "features_per_image": int(images[0][0].shape[0]),
           "first_batch_s": first - t0,
           "images_per_s": (LM_PHOTOS - N_REQ) / seconds,
           "global_vs_single_scale_max": d_global}
    if counts["K1"] != LM_PHOTOS // N_REQ or d_global > LM_TOL or \
            len(local) != 5 or not all(bool(torch.isfinite(f).all())
                                       for f, _ in images):
        raise AssertionError("local features: %s" % res)
    del model, net, gl, local, glob, single, x0
    torch.cuda.empty_cache()
    return res, images


def _lm_nearest64(points, centroids):
    """Float64 argmin and the relative gap to the second nearest."""
    from gandtr_tpu_torch.models.grouping import cdist
    d = cdist(points.double(), centroids.double())
    two = torch.topk(d, 2, dim=1, largest=False)
    return d.argmin(dim=1), (two.values[:, 1] - two.values[:, 0]) / \
        two.values[:, 0].clamp_min(1e-30)


def _lm_codebook(dev, points, tmp):
    """(b): ClusteringCodebook(64k) by k-means over the codebook photos'
    local features; the pickle round trip; the last iteration's
    assignment on a sample against float64."""
    import pickle
    from gandtr_tpu_torch.models import grouping as G
    book = G.ClusteringCodebook(LM_BOOK, *LM_HARD, iterations=LM_ITERATIONS,
                                outputdim=points.shape[1]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    book.compute_codebook(points, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        init = G.init_clusters_forgy(
            points, G.parse_size(LM_BOOK),
            torch.Generator(device=dev).manual_seed(0))
        c9 = G.iterate_kmeans(points, init, LM_ITERATIONS - 1)
        again = G.iterate_kmeans(points, c9, 1)
        sample = points[torch.randperm(
            points.shape[0], generator=torch.Generator(device=dev)
            .manual_seed(1), device=dev)[:LM_SAMPLE]]
        got = G.nearest(sample, c9, 1)[1][:, 0]
        want, gap = _lm_nearest64(sample, c9)
    flips = got != want
    path = os.path.join(tmp, "codebook_64k.pkl")
    with open(path, "wb") as handle:
        pickle.dump({"state": {"centroids":
                               book.codebook.detach().cpu().numpy()}},
                    handle)
    loaded = G.LoadedCodebook(path, *LM_HARD).to(dev)
    res = {"points": int(points.shape[0]), "centroids": G.parse_size(LM_BOOK),
           "iterations": LM_ITERATIONS, "s_per_iteration":
           seconds / LM_ITERATIONS, "repeat_bit_equal":
           bool(torch.equal(again, book.codebook.detach())),
           "pickle_bit_equal": bool(torch.equal(loaded.codebook,
                                                book.codebook)),
           "sample_flips": int(flips.sum()),
           "flip_gap_max": float(gap[flips].max()) if flips.any() else 0.0,
           "clusters_at_their_initial_point": int(
               (book.codebook.detach() == init).all(1).sum())}
    if not (res["repeat_bit_equal"] and res["pickle_bit_equal"]) or \
            bool((gap[flips] >= LM_GAP).any()) or \
            not bool(torch.isfinite(book.codebook).all()):
        raise AssertionError("codebook: %s" % res)
    del c9, again, init, sample
    return res, path


def _lm_rows_agree(images, centroids, reduced=None):
    """Per image, the centroid rows whose assigned features are the same
    in float32 and float64 (`nearest`), as a (n_images, K) mask, and the
    count of features whose nearest centroid differs."""
    from gandtr_tpu_torch.models.grouping import nearest
    K = centroids.shape[0]
    masks, flips = [], 0
    for f, _ in (reduced or images):
        ok = torch.ones(K, dtype=torch.bool, device=centroids.device)
        if f.shape[0]:
            i32 = nearest(f, centroids)[1][:, 0]
            i64 = nearest(f.double(), centroids.double())[1][:, 0]
            diff = i32 != i64
            ok[i32[diff]] = False
            ok[i64[diff]] = False
            flips += int(diff.sum())
        masks.append(ok)
    return torch.stack(masks), flips


def _lm_vs_float64(group, images, centroids):
    """The grouping's descriptors and weights in float32 and in float64 on
    the same centroids and features: the largest differences over the rows
    whose assignments agree."""
    with torch.no_grad():
        d32, w32 = group.assign_images(images, centroids)
        d64, w64 = group.assign_images(
            [(f.double(), a.double()) for f, a in images], centroids.double())
    ok, flips = _lm_rows_agree(images, centroids)
    return {"descriptor_max": float((d32.double() - d64)[ok].abs().max()),
            "weights_max": float((w32.double() - w64)[ok].abs().max()),
            "rows_compared": int(ok.sum()), "feature_flips": flips}


def _lm_hard(dev, images, path):
    """(c): the 64k hard path on the tuple, with and without top_centroids
    8k; the 512k codebook with top_centroids 8k and its extra peak."""
    from gandtr_tpu_torch.models import grouping as G
    out = {}
    # 8k as the model side's cell; 2k, fewer than the pospair's
    # centroids, so features assigned to dropped ones are filtered out too
    for label, top in (("64k", None), ("64k_top8k", LM_TOP),
                       ("64k_top2k", LM_TOP_FEW)):
        book = G.LoadedCodebook(path, *LM_HARD, top_centroids=top).to(dev)
        with torch.no_grad():
            first = book(images)
            second = book(images)
            ms = _timed(lambda: book(images), reps=3)
            codebook, reduced = book.reduce(images)
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        cmp = _lm_vs_float64(book, reduced, codebook.detach())
        out[label] = dict(cmp, ms_per_tuple=ms, bit_equal_twice=same,
                          centroids_kept=int(codebook.shape[0]),
                          features_kept=int(sum(f.shape[0]
                                                for f, _ in reduced)))
        if not same or cmp["descriptor_max"] > LM_TOL or \
                cmp["weights_max"] > LM_TOL or \
                not all(bool(torch.isfinite(t).all()) for t in first) or \
                (top == LM_TOP_FEW and out[label]["features_kept"]
                 >= sum(f.shape[0] for f, _ in images)):
            raise AssertionError("hard path %s: %s" % (label, out[label]))
        del book, first, second, codebook, reduced
    feats = torch.cat([f for f, _ in images])
    g = torch.Generator(device=dev).manual_seed(5)
    big = (feats.mean(0) + feats.std(0) * torch.randn(
        G.parse_size(LM_BIG), feats.shape[1], generator=g, device=dev))
    book = G.Codebook(big, *LM_HARD, top_centroids=LM_TOP).to(dev)
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        first = book(images)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        second = book(images)
        ms = _timed(lambda: book(images), reps=2)
        codebook, reduced = book.reduce(images)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    out["512k_top8k"] = dict(
        _lm_vs_float64(book, reduced, codebook.detach()),
        extra_peak_gib=extra / 2 ** 30,
        codebook_gib=book.codebook.numel() * 4 / 2 ** 30,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        ms_per_tuple=ms, bit_equal_twice=same,
        centroids_kept=int(codebook.shape[0]),
        features_kept=int(sum(f.shape[0] for f, _ in reduced)))
    if not same or extra / 2 ** 30 >= LM_EXTRA_GIB or \
            out["512k_top8k"]["descriptor_max"] > LM_TOL or \
            out["512k_top8k"]["weights_max"] > LM_TOL:
        raise AssertionError("512k: %s" % out["512k_top8k"])
    del book, first, second, codebook, reduced
    torch.cuda.empty_cache()
    return out


def _lm_soft_and_batch(dev, image, path):
    """(d): Codebook(1k) with softmax-20 assignment, and BatchClustering
    (kmeans, 256 clusters, 10 iterations), on one image's scale-1
    features."""
    from gandtr_tpu_torch.models import grouping as G
    full = G.LoadedCodebook.load_codebook(path)
    idx = torch.randperm(full.shape[0], generator=torch.Generator()
                         .manual_seed(2))[:LM_SOFT_K]
    soft = G.Codebook(full[idx], *LM_SOFT).to(dev)
    with torch.no_grad():
        first = soft([image])
        ms = _timed(lambda: soft([image]), reps=2)
        again = soft([image])
    out = {"soft": dict(_lm_vs_float64(soft, [image], soft.codebook.detach()),
                        ms=ms, bit_equal_twice=all(
                            torch.equal(a, b) for a, b in zip(first, again)))}
    del soft, first, again
    seen = []
    batch = G.BatchClustering(LM_BATCH_K, *LM_BATCH, "kmeans",
                              LM_ITERATIONS, outputdim=image[0].shape[1],
                              seed=4)
    assign = batch.assign_images
    batch.assign_images = lambda ims, c: seen.append(c) or assign(ims, c)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch([image])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    out["batch_clustering"] = dict(
        _lm_vs_float64(G.Grouping(LM_BATCH_K, *LM_BATCH), [image], seen[0]),
        ms=ms)
    for key, r in out.items():
        if r["descriptor_max"] > LM_TOL or r["weights_max"] > LM_TOL or \
                not r.get("bit_equal_twice", True):
            raise AssertionError("%s: %s" % (key, out))
    torch.cuda.empty_cache()
    return out


def _lm_grads(book, images, dtype):
    """Gradients of a seeded projection of the descriptors into the
    features and the codebook."""
    cb = book.codebook.detach().to(dtype).requires_grad_(True)
    ims = [(f.detach().to(dtype).requires_grad_(True), a.to(dtype))
           for f, a in images]
    d, _ = book.assign_images(ims, cb)
    R = torch.randn(d.shape, generator=torch.Generator(device=d.device)
                    .manual_seed(6), device=d.device).to(dtype)
    (d * R).sum().backward()
    return [f.grad for f, _ in ims], cb.grad


def _lm_gradient(dev, images, path):
    """(e): one backward through the 64k hard path: twice bit-equal, and
    within LM_TOL of the float64 backward (relative to its largest
    gradient) over the features and centroid rows whose assignments
    agree."""
    from gandtr_tpu_torch.models import grouping as G
    book = G.LoadedCodebook(path, *LM_HARD).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g1, c1 = _lm_grads(book, images, torch.float32)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    g2, c2 = _lm_grads(book, images, torch.float32)
    same = all(torch.equal(a, b) for a, b in zip(g1 + [c1], g2 + [c2]))
    del g2, c2
    g64, c64 = _lm_grads(book, images, torch.float64)
    ok, flips = _lm_rows_agree(images, book.codebook.detach())
    rows = ok.all(0)
    feat_err, feat_max = 0.0, 0.0
    with torch.no_grad():
        for (f, _), a, b, okr in zip(images, g1, g64, ok):
            keep = okr[G.nearest(f, book.codebook.detach())[1][:, 0]]
            feat_err = max(feat_err, float((a.double() - b)[keep].abs()
                                           .max()))
            feat_max = max(feat_max, float(b.abs().max()))
        book_err = float((c1.double() - c64)[rows].abs().max())
        book_max = float(c64.abs().max())
    res = {"ms": ms, "bit_equal_twice": same, "feature_flips": flips,
           "features_rel": feat_err / feat_max,
           "codebook_rel": book_err / book_max,
           "codebook_rows_compared": int(rows.sum())}
    if not same or res["features_rel"] > LM_TOL or \
            res["codebook_rel"] > LM_TOL:
        raise AssertionError("gradient: %s" % res)
    del book, g1, c1, g64, c64
    torch.cuda.empty_cache()
    return res


def _chain_bound(y, y_plain, y_f32):
    """The C.2 rule: the K3 chain's largest distance from the float32
    chain within CHAIN_FACTOR of the plain bf16 chain's."""
    dk = float((y.float() - y_f32).abs().max())
    dp = float((y_plain.float() - y_f32).abs().max())
    return {"k3_vs_f32_max": dk, "plain_vs_f32_max": dp,
            "factor": dk / dp if dp else float("inf"),
            "within": dk <= CHAIN_FACTOR * dp}


def _mh_nets(dev, dtype):
    """base official_resnet_encoder (6 blocks, instance norm) -> heads
    day and night (official_resnet_decoder each), seeded kaiming_p2p."""
    from gandtr_tpu_torch.learning.network import MultiheadModule, WrappedNet
    from gandtr_tpu_torch.models import initialize_model
    from gandtr_tpu_torch.models.init import initialize_weights
    nets = {}
    for i, (name, half) in enumerate((("base", "encoder"), ("day", "decoder"),
                                      ("night", "decoder"))):
        m = initialize_model({"architecture": "official_resnet_%s" % half,
                              "n_blocks": 6, "norm_type": "instance"})
        initialize_weights(m, "kaiming_p2p", seed=10 + i)
        nets[name] = WrappedNet(module=m.to(dev), compute_dtype=dtype)
    base = nets.pop("base")
    return MultiheadModule(base, nets, default_output="night",
                           parameter_groups=MH_GROUPS)


def _retyped(mh, dtype):
    """The same modules (shared weights) under another compute dtype."""
    from gandtr_tpu_torch.learning.network import MultiheadModule, WrappedNet
    return MultiheadModule(
        WrappedNet(module=mh.base, compute_dtype=dtype),
        {n: WrappedNet(module=getattr(mh, n), compute_dtype=dtype)
         for n in mh.head_names}, default_output=mh.default_output,
        parameter_groups=mh.parameter_groups)


def _mh_adam(mh, dev, photos):
    """One float32 Adam step of MH_ADAM with MH_GROUPS on MH_STEP_HW crops:
    the updated weights and each group's (lr, weight_decay)."""
    import copy
    from gandtr_tpu_torch.learning.optimizers import initialize_optimizer
    mh = copy.deepcopy(_retyped(mh, None)).to(dev).train()
    opt, _ = initialize_optimizer(dict(MH_ADAM), mh.named_parameters(), "",
                                  mh.parameter_groups)
    x = torch.from_numpy(photos[:2, :MH_STEP_HW, :MH_STEP_HW]).to(dev) \
        .float() / 127.5 - 1.0
    mh.default_output = None
    out = mh(x)
    loss = sum(((out[h] - x.flip(-1)) ** 2).mean() for h in mh.head_names)
    opt.zero_grad()
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in mh.named_parameters()}
    opt.step()
    groups = {}
    for name, p in mh.named_parameters():
        g = next(g for g in opt.param_groups if any(q is p for q in
                                                    g["params"]))
        groups[name.split(".", 1)[0]] = (g["lr"], g["weight_decay"])
    return ({k: v.detach().cpu() for k, v in mh.state_dict().items()},
            groups, float(loss), grads)


def _lm_multihead(dev, photos):
    """(f): the bf16 multi-head net on N_REQ photos: K3 18 times, each
    block call held by _k3_held; default_output against the all-outputs
    dict; each head bounded by the C.2 rule; one float32 Adam step with
    parameter groups on the card against the CPU port."""
    from gandtr_tpu_torch.ops import resblock
    mh = _mh_nets(dev, torch.bfloat16).eval()
    x = torch.from_numpy(photos[:N_REQ]).to(dev).float() / 127.5 - 1.0
    calls, kernel = [], resblock.fused_resblock

    def recording(*args, **kwargs):
        out = kernel(*args, **kwargs)
        calls.append((args, out))
        return out
    with torch.inference_mode():
        default = mh(x)
        torch.cuda.synchronize()
        mh.default_output = None
        resblock.fused_resblock = recording
        reset_launches()
        try:
            outs = mh(x)
            torch.cuda.synchronize()
        finally:
            resblock.fused_resblock = kernel
        counts = launches()
        ms = cuda_ms(lambda: mh(x), reps=3)
        resblock.fused_resblock = resblock.fused_resblock_plain
        try:
            plain = mh(x)
            plain_ms = cuda_ms(lambda: mh(x), reps=2)
        finally:
            resblock.fused_resblock = kernel
        f32 = _retyped(mh, None).eval()(x)
    errs = _k3_held(calls)
    del calls
    res = {"launches": counts, "ms": ms, "plain_ms": plain_ms,
           "images_per_s": N_REQ / ms * 1e3,
           "default_equals_dict": bool(torch.equal(default, outs["night"])),
           "block_calls": len(errs),
           "block_calls_max_abs_err": max(e[0] for e in errs),
           "block_calls_mean_abs_err": max(e[1] for e in errs),
           "block_calls_past_bound": sum(e[5]["past_bound"] for e in errs)}
    for h in ("base",) + mh.head_names:
        d = (outs[h].float() - plain[h].float()).abs()
        res[h] = dict(_chain_bound(outs[h], plain[h], f32[h]),
                      vs_plain_max=float(d.max()),
                      vs_plain_mean=float(d.mean()),
                      shape=list(outs[h].shape))
    # the heads' tanh outputs as the encoder -> decoder chain's; the base's
    # unbounded residual stream by the float32 rule alone (its block calls
    # are held above)
    ok = (counts["K3"] == 18 and len(errs) == 18
          and all(e[3] for e in errs) and res["default_equals_dict"]
          and res["block_calls_mean_abs_err"] < K3_MEAN
          and all(res[h]["within"]
                  and bool(torch.isfinite(outs[h].float()).all())
                  for h in ("base",) + mh.head_names)
          and all(res[h]["vs_plain_mean"] < K3_MEAN for h in mh.head_names))
    if not ok:
        raise AssertionError("multi-head: %s" % res)
    del default, outs, plain, f32, errs, x
    torch.cuda.empty_cache()
    card, groups, loss, g_card = _mh_adam(mh, dev, photos)
    cpu, cpu_groups, cpu_loss, g_cpu = _mh_adam(mh, torch.device("cpu"),
                                                photos)
    lr = MH_ADAM["lr"]
    wd = MH_ADAM["weight_decay"]
    want = {h: (lr * MH_GROUPS.get(h, {}).get("lr", 1.0),
                wd * MH_GROUPS.get(h, {}).get("weight_decay", 1.0))
            for h in ("base",) + mh.head_names}
    start = {k: v.detach().cpu() for k, v in mh.state_dict().items()}
    # a move of at most the group's lr, less the float32 rounding of the
    # updated weight (half an ulp, at most 2^-24 of it)
    moved = {h: max(float(((card[k] - start[k]).abs()
                           - 2.0 ** -24 * card[k].abs()).max())
                    for k in card if k.startswith(h + "."))
             for h in want}
    res["adam"] = {"groups": groups, "loss": loss, "cpu_loss": cpu_loss,
                   "vs_cpu_max": max(float((card[k] - cpu[k]).abs().max())
                                     for k in card),
                   "update_signs_differ": sum(int(
                       ((card[k] - start[k]).sign()
                        != (cpu[k] - start[k]).sign()).sum()) for k in card),
                   "parameters": sum(v.numel() for v in card.values()),
                   "largest_move": moved,
                   # printed: the gradients' card / CPU distance, relative
                   # to each subnet's largest CPU gradient
                   "grad_rel_max": {h: max(
                       float((g_card[k] - g_cpu[k]).abs().max())
                       for k in g_cpu if k.startswith(h + ".")) / max(
                       float(g_cpu[k].abs().max())
                       for k in g_cpu if k.startswith(h + "."))
                       for h in want}}
    if groups != cpu_groups or any(
            abs(groups[h][0] - want[h][0]) > 1e-12 * want[h][0]
            or groups[h][1] != want[h][1] for h in want) or \
            res["adam"]["vs_cpu_max"] > LM_TOL or any(
                not 0 < moved[h] <= 1.01 * want[h][0] for h in want):
        raise AssertionError("multi-head Adam step: %s" % res["adam"])
    del mh
    torch.cuda.empty_cache()
    return res


def run_local_multihead(dev):
    """The model side (the module docstring's item 18), each part with
    every launch count set to 0 just before it and read just after: (a)
    _lm_local, (b) _lm_codebook, (c) _lm_hard, (d) _lm_soft_and_batch,
    (e) _lm_gradient, (f) _lm_multihead. Prints each part and the phase's
    seconds."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="local_", dir=os.environ.get("TMPDIR"))
    out, t_all = {}, time.perf_counter()

    def part(key, fn):
        t0 = time.perf_counter()
        reset_launches()
        r = fn()
        r.setdefault("launches", launches())
        r["phase_s"] = time.perf_counter() - t0
        out[key] = r
        print("local_multihead %s (%s): %s" % (key, card_line(),
                                               json.dumps(r)))
        torch.cuda.empty_cache()
    try:
        held = {}
        part("local", lambda: held.setdefault("local", _lm_local(dev))[0])
        images = held.pop("local")[1]
        tup = images[LM_BOOK_PHOTOS:LM_BOOK_PHOTOS + LM_TUPLE]
        points = torch.cat([f for f, _ in images[:LM_BOOK_PHOTOS]])
        del images
        part("codebook", lambda: held.setdefault(
            "book", _lm_codebook(dev, points, tmp))[0])
        path = held["book"][1]
        del points
        part("hard", lambda: _lm_hard(dev, tup, path))
        part("soft_and_batch", lambda: _lm_soft_and_batch(
            dev, _scale1(tup[0], out["local"]), path))
        part("gradient", lambda: _lm_gradient(dev, tup, path))
        del tup
        rs = np.random.RandomState(18)
        photos = np.stack([np.asarray(_photo(rs, *HW))
                           for _ in range(N_REQ)])
        part("multihead", lambda: _lm_multihead(dev, photos))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("local", "codebook", "hard", "soft_and_batch",
                               "gradient", "multihead"))
                       for k in ("K1", "K2", "K3", "K4")}
    out["phase_s"] = time.perf_counter() - t_all
    print("local_multihead (%s): %.1f s, launches %s"
          % (card_line(), out["phase_s"], json.dumps(out["launches"])))
    return out


def _scale1(image, local):
    """An image's scale-1 features and attentions (the first of its
    flattened scales)."""
    h, w = local["scales_hw"][0]
    return image[0][:h * w], image[1][:h * w]


# ---- 20. data parallelism, sharded artifacts and the native decoder
PAR_T = 4            # the 2-rank fine-tune step's tuples (2 a rank)
PAR_GAN_BATCH = 10   # the HED^N-GAN step's global batch (5 a rank)
PAR_GAN_HW = 256
PAR_EVAL_IMAGES = 8  # eval photos extracted over the ranks
PAR_GAN_METRIC_REL = 1e-3    # §2: a GAN step's losses, card vs card
# the gradients each optimizer steps with, relative norm against one
# process's: G's pass the L1 edge loss on 256² maps, whose subgradient
# turns sign at near-ties, so rounding that turns a few pixels moves
# them by percents (PERF.md §6, call 5)
PAR_GAN_GRAD_REL = {"generator_X": 0.1, "discriminator_Y": 1e-3,
                    "detector": 1e-3}
PAR_DECODE = 24      # photos decoded by the native pool and by PIL


def _par_gan_cfg(parallel):
    """train_hedngan.yml as shipped at full width (GAN_TRAIN), the HED
    files seeded, without its data section: the step alone."""
    import copy
    cfg = copy.deepcopy(GAN_TRAIN)
    for k in ("detector", "detector_frozen"):
        cfg["network"][k]["model"]["pretrained"] = None
    cfg["learning"]["training"]["parallel"] = parallel
    cfg.pop("data", None)
    return cfg


def _par_ft_cfg(parallel):
    cfg = finetune_config()
    cfg["learning"]["training"]["parallel"] = parallel
    cfg["data"]["train"]["loader"]["batch_size"] = PAR_T
    return cfg


def _par_finetune(dev, parallel):
    """finetune.yml's bf16 step at T=PAR_T on `dev` (the build data-
    parallel under a group): its launches, loss, embed weights after Adam
    and tuple 0's descriptors after the step."""
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    exp = build_finetune_experiment(_par_ft_cfg(parallel), device=dev)
    batch = finetune_batch(dev, T=PAR_T)
    torch.cuda.synchronize()
    reset_launches()
    state, m = exp["step"](exp["state"], *batch)
    torch.cuda.synchronize()
    counts = launches()
    x, masks = exp["stage"](batch[0], batch[1])
    return {"launches": counts, "loss": float(m["total"]),
            "dp": bool(getattr(exp["step"], "gandtr_dp", False)),
            "weights": {k: v.cpu() for k, v in _embed_params(exp).items()},
            "desc": _descriptors(exp, x, masks, batch[3]).cpu()}


def _step_grads(exp):
    """A pre-step hook on each optimizer, registered after the build's
    own (the data-parallel all-reduce), that keeps the gradients it steps
    with on the host: {name: [one flat float32 tensor a step call]}."""
    grads = {}
    for name, o in exp["optimizers"].items():
        opt = o if isinstance(o, torch.optim.Optimizer) else o.optimizer
        grads[name] = []

        def hook(opt, args, kwargs, _into=grads[name]):
            _into.append(torch.cat([
                p.grad.detach().reshape(-1).float()
                for g in opt.param_groups for p in g["params"]
                if p.grad is not None]).cpu())
        opt.register_step_pre_hook(hook)
    return grads


def _par_gan(dev, parallel, X, Y, control=False):
    """One HED^N-GAN step at full width on the global batch (X, Y): its
    metrics, every net's weights and statistics after it, and the
    gradients each optimizer stepped with. `control`: the same step with
    the gradients' all-reduce off (each rank steps with its own rows'
    gradients), the reading a broken step gives."""
    from gandtr_tpu_torch.parallel import mesh
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    exp = build_gan_experiment(_par_gan_cfg(parallel), device=dev)
    grads = _step_grads(exp)
    reduce_grads = mesh.all_reduce_grads
    if control:
        mesh.all_reduce_grads = lambda params, scale=1.0: None
    try:
        state, m, _ = exp["step"](exp["state"],
                                  torch.from_numpy(X).to(dev),
                                  torch.from_numpy(Y).to(dev))
        torch.cuda.synchronize()
    finally:
        mesh.all_reduce_grads = reduce_grads
    return {"metrics": {k: float(v) for k, v in m.items()},
            "dp": bool(getattr(exp["step"], "gandtr_dp", False)),
            "state": _gan_snapshot(exp), "grads": grads,
            "lr": {n: max(g["lr"] for g in o.param_groups)
                   for n, o in exp["optimizers"].items()}}


def _grad_hashes(grads):
    import hashlib
    return {n: [hashlib.sha256(g.numpy().tobytes()).hexdigest()
                for g in gs] for n, gs in grads.items()}


def _par_extract(dev, root, lw_path, paths):
    """Eval extraction of `paths` by eval.yml's chain, exact (K1) and
    bucketed (K4): {bucket: ((D, N) descriptors, launches)}."""
    from gandtr_tpu_torch.eval.retrieval import extract_vectors
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    out = {}
    for bucket in (None, 64):
        setup = build_eval(eval_params(root, lw_path, bucket), dev)
        torch.cuda.synchronize()
        reset_launches()
        vecs = extract_vectors(setup["extractor"], paths,
                               EVAL["data"]["image_size"],
                               setup["transform"])
        out[bucket] = (vecs, launches())
    return out


def _parallel_rank(rank, world, port, job):
    """One rank of run_parallel's gloo group on the one card: the 2-rank
    fine-tune step, HED^N-GAN step and extraction; rank 0 writes what it
    holds, every rank its launches."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    spec = torch.load(job, weights_only=False)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0)
        out = {"finetune": _par_finetune(dev, {"devices": world}),
               "gan": _par_gan(dev, {"devices": world}, *spec["gan_batch"]),
               "gan_control": _par_gan(dev, {"devices": world},
                                       *spec["gan_batch"], control=True),
               "extract": _par_extract(dev, spec["root"], spec["lw"],
                                       spec["paths"])}
        out["gan"]["grad_hashes"] = _grad_hashes(out["gan"]["grads"])
        if rank:
            out = {"finetune": {"launches": out["finetune"]["launches"],
                                "loss": out["finetune"]["loss"]},
                   "extract": {b: (None, c) for b, (_, c)
                               in out["extract"].items()},
                   "gan": {"grad_hashes": out["gan"]["grad_hashes"]}}
        torch.save(out, "%s.%d" % (job, rank))
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel_max(a, b):
    return float((a.double() - b.double()).abs().max()
                 / max(float(b.double().abs().max()), 1e-30))


def _par_check_finetune(r0, r1, one):
    """PERF.md §2's step rule, 2 ranks against one process on the same
    global batch: the loss within 1%, tuple 0's descriptors within 5e-3,
    the updated weights' largest difference within 1e-4 of their largest
    value; K2 2 and K4 1 a tuple on each rank."""
    loss_rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
    desc = float((r0["desc"] - one["desc"]).abs().max())
    w = max(_rel_max(r0["weights"][k], v) for k, v in one["weights"].items())
    per_rank = PAR_T // 2
    out = {"loss_rel": loss_rel, "desc_max": desc, "weights_rel": w,
           "launches_rank0": r0["launches"], "launches_rank1": r1["launches"]}
    print("parallel (a) fine-tune step, 2 ranks vs one process: %s"
          % json.dumps(out))
    for r in (r0, r1):
        if r["launches"]["K2"] != 2 * per_rank or \
                r["launches"]["K4"] != per_rank:
            raise AssertionError("a rank launched %s for %d tuples"
                                 % (r["launches"], per_rank))
    if not (r0["dp"] and loss_rel <= 1e-2
            and desc <= 5e-3 and w <= 1e-4):
        raise AssertionError("the 2-rank fine-tune step is off: %s" % out)
    return out


def _gan_distance(r, one):
    """(each optimizer's gradients: the largest relative norm of the
    difference over its step calls, each net's BatchNorm statistics: the
    largest difference over their size, each trained net's largest
    weight difference in units of its largest group lr) of run `r`
    against `one`."""
    lr = one["lr"]
    grads = {n: max(float(torch.linalg.vector_norm((a - b).double())
                          / torch.linalg.vector_norm(b.double()))
                    for a, b in zip(r["grads"][n], gs))
             for n, gs in one["grads"].items() if gs}
    worst, stats = {}, {}
    for name, sd in one["state"].items():
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            got = r["state"][name][k]
            if "running" in k:
                stats[name] = max(stats.get(name, 0.0), _rel_max(got, v))
            elif name in lr:
                d = float((got.double() - v.double()).abs().max())
                worst[name] = max(worst.get(name, 0.0), d / lr[name])
    return grads, stats, worst


def _par_check_gan(r0, r1, control, one):
    """The 2-rank HED^N-GAN step with global BatchNorm against one
    process: the gradients each optimizer steps with (summed over the
    ranks and scaled) within their PAR_GAN_GRAD_REL relative norm of one
    process's, and bit-equal on both ranks; the losses within
    PAR_GAN_METRIC_REL relative (phase 11's card-vs-CPU rule); every
    trained weight within 2 lr (Adam's first step, at each net's largest
    group lr); the generator's BatchNorm statistics (one forward, before
    any update) within 1e-5 of their size, the discriminator's within
    1e-3 (its third forward runs after its update, on weights that may
    differ by 2 lr). The control (the same ranks with the all-reduce off)
    must be beyond its PAR_GAN_GRAD_REL on every optimizer, so the
    gradient rule can tell a broken step; its readings are printed
    beside."""
    rel = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-6)
              for k, v in one["metrics"].items())
    grads, stats, worst = _gan_distance(r0, one)
    c_grads, c_stats, c_worst = _gan_distance(control, one)
    out = {"metrics_rel": rel, "grads_rel": grads, "bn_stats_rel": stats,
           "weights_in_lr": worst,
           "grads_ranks_equal": r0["grad_hashes"] == r1["grad_hashes"],
           "control": {"grads_rel": c_grads, "bn_stats_rel": c_stats,
                       "weights_in_lr": c_worst}}
    print("parallel (a) HED^N-GAN step, batch %d at %d², 2 ranks vs one "
          "process: %s" % (PAR_GAN_BATCH, PAR_GAN_HW, json.dumps(out)))
    if not (r0["dp"] and out["grads_ranks_equal"]
            and sorted(grads) == sorted(PAR_GAN_GRAD_REL)
            and all(grads[n] <= PAR_GAN_GRAD_REL[n] for n in grads)
            and all(c_grads.get(n, 0.0) > PAR_GAN_GRAD_REL[n] for n in grads)
            and rel <= PAR_GAN_METRIC_REL
            and stats.get("generator_X", 1.0) <= 1e-5
            and stats.get("discriminator_Y", 1.0) <= 1e-3
            and all(v <= 2.0 for v in worst.values())):
        raise AssertionError("the 2-rank GAN step is off: %s" % out)
    return out


def _par_nccl(dev, one):
    """(b) one rank over NCCL: the fine-tune step bit-equal to the run
    without a process group."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d"
                            % _free_port(), rank=0, world_size=1)
    try:
        r = _par_finetune(dev, {"devices": 1})
    finally:
        dist.destroy_process_group()
    same = (r["dp"] and r["loss"] == one["loss"]
            and all(torch.equal(r["weights"][k], v)
                    for k, v in one["weights"].items())
            and torch.equal(r["desc"], one["desc"]))
    print("parallel (b) NCCL world 1: data-parallel %s, bit-equal to no "
          "group %s, launches %s" % (r["dp"], same, r["launches"]))
    if not same:
        raise AssertionError("the NCCL world-1 step differs")
    return r["launches"]


def _par_artifacts(dev, tmp):
    """(d) the served generator (hub cyclegan, bf16) and descriptor (hub
    GeM-VGG16, 3 scales, the seeded Lw) as artifacts sharded 2 ways on
    [cuda:0, cuda:0] (4 rows a share, each on its own stream) against
    their unsharded artifacts (bucket 8) on the same 8 photos: the
    generator within one uint8 level, the descriptors within 1e-4; K3 9
    and K1 once a share; ms a batch of 8 each way (the card's own)."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.serving.export import (export_hub_model,
                                                 export_sharded_model,
                                                 load_artifact)
    images = np.random.RandomState(5).randint(
        0, 256, (N_REQ,) + HW + (3,), dtype=np.uint8)
    gen = hub.cyclegan(pretrained=False)
    gen.net.compute_dtype = torch.bfloat16
    emb = hub.gem_vgg16_hedngan(pretrained=False, whitening=seeded_lw())
    out, counts = {}, {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for kind, model in (("generator", gen), ("descriptor", emb)):
        t0 = time.perf_counter()
        sp, up = os.path.join(tmp, kind + "_sharded"), \
            os.path.join(tmp, kind + "_plain")
        export_sharded_model(model, sp, HW, 2, batch_per_device=N_REQ // 2)
        export_hub_model(model, up, HW, batch_buckets=(N_REQ,))
        export_s = time.perf_counter() - t0
        sharded = load_artifact(sp, devices=[dev, dev])
        plain = load_artifact(up, device=dev)
        want = plain(images)
        sharded(images)     # loads the programs
        torch.cuda.synchronize()
        reset_launches()
        got = sharded(images)
        torch.cuda.synchronize()
        c = launches()
        for k in counts:
            counts[k] += c[k]
        ms = {"sharded_ms": 1e3 * _wall(lambda: sharded(images)),
              "plain_ms": 1e3 * _wall(lambda: plain(images))}
        if kind == "generator":
            diff = int(np.abs(got.astype(int) - want.astype(int)).max())
            ok = got.shape == want.shape and diff <= 1 and c["K3"] == 18
        else:
            diff = float(np.abs(got - want).max())
            ok = got.shape == want.shape and diff <= 1e-4 and c["K1"] == 2
        out[kind] = {"max_diff": diff, "launches": c, "export_s": export_s,
                     **ms}
        if not ok:
            raise AssertionError("sharded %s artifact: %s" % (kind,
                                                              out[kind]))
    print("parallel (d) sharded artifacts on [cuda:0, cuda:0]: %s"
          % json.dumps(out))
    return out, counts


def _wall(fn, reps=3):
    """Median host seconds of fn() ending in a synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _par_decoder(tmp, card):
    """(e) which decoder runs, and where the native one built: its decode
    of seeded JPEGs and PNGs byte-equal to PIL's, its 6-thread batch
    decode against PIL on 6 threads."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    from gandtr_tpu_torch import native
    from gandtr_tpu_torch.scenarios.run import decoder_line
    print("parallel (e) %s" % decoder_line())
    if not native.available():
        return {"native": False, "build_error": str(native.build_error())}
    rs = np.random.RandomState(9)
    paths = []
    for i in range(PAR_DECODE):
        img = _photo(rs, *EVAL_SHAPES[i % len(EVAL_SHAPES)])
        paths.append(os.path.join(tmp, "d%02d.%s" % (
            i, "png" if i % 6 == 5 else "jpg")))
        img.save(paths[-1], **({} if i % 6 == 5 else {"quality": 90}))

    def pil(p):
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB"))
    with native.DecodePool(6) as pool:
        outs = pool.decode_batch(paths)
        for o, p in zip(outs, paths):
            if o is None or not np.array_equal(o, pil(p)):
                raise AssertionError("native decode of %s is not PIL's" % p)
        t_nat = _host_s(lambda: pool.decode_batch(paths))
    with ThreadPoolExecutor(6) as ex:
        t_pil = _host_s(lambda: list(ex.map(pil, paths)))
    out = {"native": True, "byte_equal_images": len(paths),
           "native_images_per_s": len(paths) / t_nat,
           "pil_images_per_s_6_threads": len(paths) / t_pil}
    print("parallel (e) decode of %d photos up to 1280x960 (%s): %s"
          % (len(paths), card, json.dumps(out)))
    return out


def _host_s(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run_parallel(dev):
    """Phase 19 (docstring item 19): data parallelism over torch.distributed
    on the one card, the sharded artifacts and the native decoder. The
    launch counts of the counted parts: each rank's of the 2-rank step and
    extraction, and the parent's of the NCCL step and the artifacts."""
    import tempfile
    import torch.multiprocessing as mp
    card = card_line()
    t_phase = time.perf_counter()
    totals = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def add(c):
        for k in totals:
            totals[k] += c[k]
    with tempfile.TemporaryDirectory() as tmp:
        lw_path = os.path.join(tmp, "lw.pkl")
        import pickle
        with open(lw_path, "wb") as f:
            pickle.dump(seeded_lw(), f)
        paths = make_eval_set(tmp)[:PAR_EVAL_IMAGES]
        X, Y = _seeded_gan_batches(1, PAR_GAN_BATCH, PAR_GAN_HW, 3)[0]
        job = os.path.join(tmp, "job.pt")
        torch.save({"gan_batch": (X, Y), "root": tmp, "lw": lw_path,
                    "paths": paths}, job)
        t0 = time.perf_counter()
        mp.spawn(_parallel_rank, args=(2, _free_port(), job), nprocs=2,
                 join=True)
        ranks_s = time.perf_counter() - t0
        print("parallel: the two ranks took %.1f s" % ranks_s)
        r0, r1 = (torch.load("%s.%d" % (job, r), weights_only=False)
                  for r in (0, 1))

        # the same work in one process, no group
        one_ft = _par_finetune(dev, {"devices": 2})
        ft = _par_check_finetune(r0["finetune"], r1["finetune"], one_ft)
        gan = _par_check_gan(r0["gan"], r1["gan"], r0["gan_control"],
                             _par_gan(dev, False, X, Y))
        ex = {}
        one_ex = _par_extract(dev, tmp, lw_path, paths)
        for bucket, (vecs, c) in one_ex.items():
            c0, c1 = r0["extract"][bucket][1], r1["extract"][bucket][1]
            kern = "K4" if bucket else "K1"
            equal = bool(np.array_equal(r0["extract"][bucket][0], vecs))
            ex["bucketed" if bucket else "exact"] = {
                "bit_equal": equal, kern + "_rank0": c0[kern],
                kern + "_rank1": c1[kern]}
            add(c0)
            add(c1)
            if not equal or c0[kern] != PAR_EVAL_IMAGES // 2 or \
                    c1[kern] != PAR_EVAL_IMAGES // 2:
                raise AssertionError("rank-sharded extraction: %s" % ex)
        print("parallel (c) extraction of %d photos over 2 ranks: %s"
              % (PAR_EVAL_IMAGES, json.dumps(ex)))
        add(r0["finetune"]["launches"])
        add(r1["finetune"]["launches"])
        add(_par_nccl(dev, one_ft))
        arts, c = _par_artifacts(dev, tmp)
        add(c)
        dec = _par_decoder(tmp, card)
    out = {"finetune": ft, "gan": gan, "extract": ex, "artifacts": arts,
           "decoder": dec, "ranks_s": ranks_s, "launches": totals,
           "seconds": time.perf_counter() - t_phase}
    print("parallel phase (%s): %.1f s, launches %s"
          % (card, out["seconds"], json.dumps(totals)))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.serving.export import Servable
    from gandtr_tpu_torch.serving.service import encode_png, serve_http
    from PIL import Image

    card = card_line()
    print(card)
    t_run = time.perf_counter()

    def lap(name):
        print("time: %s done at %.1f s" % (name, time.perf_counter() - t_run))
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    sass_report(build_all())
    dev = torch.device("cuda")
    k1 = check_k1(dev)
    k2 = check_k2(dev)
    k4 = check_k4(dev)
    lap("kernel checks")

    lw = seeded_lw()
    model = hub.gem_vgg16_hedngan(pretrained=False, whitening=lw)
    k3 = check_k3(dev)
    gen = hub.cyclegan(pretrained=False)
    gen.net.compute_dtype = torch.bfloat16
    images = np.random.RandomState(2).randint(
        0, 256, (N_REQ,) + HW + (3,), dtype=np.uint8)

    servable = Servable(model, HW)
    gen_servable = Servable(gen, HW)
    # a long batching window: each round's 8 requests form one batch, the
    # one the direct call below runs
    server = serve_http({"gem": servable, "gen": gen_servable}, port=0,
                        block=False, max_wait_ms=1000.0)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        print("healthz:", health)
        if health["device"] != "cuda" or health["status"] != "ok":
            raise AssertionError("server is not on the card: %r" % health)

        reset_launches()
        answers, timing = serve_rounds(base, "gem", images)
        desc_launches = launches()
        t0 = time.perf_counter()
        direct = servable(images)
        timing["direct_servable_ms"] = 1e3 * (time.perf_counter() - t0)

        reset_launches()
        batches0 = server.models["gen"].batcher.batches
        gen_answers, gen_timing = serve_rounds(base, "gen", images)
        gen_launches = launches()
        gen_batches = server.models["gen"].batcher.batches - batches0
        t0 = time.perf_counter()
        gen_direct = gen_servable(images)
        gen_timing["direct_servable_ms"] = 1e3 * (time.perf_counter() - t0)
    finally:
        server.close()

    # ---- descriptor path (the first slice's checks)
    print("descriptor path: launches %s for %d served images"
          % (desc_launches, N_REQ * (ROUNDS + 1)))
    if desc_launches["K1"] < 1:
        raise AssertionError("the descriptor path never launched K1")
    served = np.asarray([json.loads(body)["descriptor"]
                         for _, body in answers], np.float32)
    if not np.isfinite(served).all() or served.shape != (N_REQ, 512):
        raise AssertionError("bad descriptors %s" % (served.shape,))
    norms = np.linalg.norm(served, axis=1)
    if np.abs(norms - 1).max() > 1e-5:
        raise AssertionError("descriptor norms %s" % norms)
    # the batcher and the direct call run the same 8-image batch; a
    # different cuDNN algorithm choice could change float32 rounding only
    d_direct = float(np.abs(served - direct).max())
    if d_direct > 1e-5:
        raise AssertionError("served vs direct: %g" % d_direct)
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = hub.gem_vgg16_hedngan(pretrained=False, whitening=lw,
                                      device="cpu")
    t0 = time.perf_counter()
    cpu_desc = Servable(cpu_model, HW)(images[:1])
    cpu_s = time.perf_counter() - t0
    # TF32 is off on the card; float32 summation order and a possible
    # one-step flip of a uint8 lightness value remain
    d_cpu = float(np.abs(served[:1] - cpu_desc).max())
    print("served vs direct %.3g, served vs CPU port %.3g (CPU took %.1f s)"
          % (d_direct, d_cpu, cpu_s))
    if d_cpu > 1e-4:
        raise AssertionError("card vs CPU port: %g" % d_cpu)
    print("descriptor serving: %.3f images/s, %.2f ms per request, %.2f ms "
          "per round of %d; the direct Servable call on the same 8 took "
          "%.2f ms" % (timing["images_per_s"], timing["ms_per_request"],
                       timing["ms_per_round"], N_REQ,
                       timing["direct_servable_ms"]))
    breakdown = stage_breakdown(model, images)
    print("descriptor breakdown (batch %d at %dx%d): %s"
          % (N_REQ, HW[0], HW[1], json.dumps(breakdown)))

    # ---- generator path
    print("generator path: launches %s, %d batches formed, %d served images"
          % (gen_launches, gen_batches, N_REQ * (ROUNDS + 1)))
    if gen_launches["K3"] < 9 or gen_launches["K3"] != 9 * gen_batches:
        raise AssertionError("K3 launched %d times for %d batches"
                             % (gen_launches["K3"], gen_batches))
    for i, (ctype, body) in enumerate(gen_answers):
        png = np.asarray(Image.open(io.BytesIO(body)))
        if ctype != "image/png" or png.dtype != np.uint8 \
                or png.shape != HW + (3,):
            raise AssertionError("bad PNG %d: %s %s %s"
                                 % (i, ctype, png.dtype, png.shape))
        if body != encode_png(gen_direct[i]) or \
                not np.array_equal(png, gen_direct[i]):
            raise AssertionError("served PNG %d differs from the direct call"
                                 % i)
    print("generator PNGs: %d decode to uint8 %s and are byte-equal to the "
          "direct call" % (len(gen_answers), HW + (3,)))
    print("generator serving: %.3f images/s, %.2f ms per request, %.2f ms "
          "per round of %d; the direct Servable call on the same 8 took "
          "%.2f ms" % (gen_timing["images_per_s"],
                       gen_timing["ms_per_request"],
                       gen_timing["ms_per_round"], N_REQ,
                       gen_timing["direct_servable_ms"]))
    gen_breakdown = generator_breakdown(gen, images,
                                        gen_timing["direct_servable_ms"],
                                        gen_timing["ms_per_round"])
    print("generator breakdown (batch %d at %dx%d, bf16): %s"
          % (N_REQ, HW[0], HW[1], json.dumps(gen_breakdown)))
    parity = generator_parity(gen, images)
    print("generator parity: %s" % json.dumps(parity))
    del model, gen, servable, gen_servable, server
    lap("serving")
    torch.cuda.empty_cache()

    # ---- fine-tune tuple step
    torch.cuda.reset_peak_memory_stats()
    ft_exp, ft_batch, ft = run_finetune(dev)
    ft["breakdown"] = finetune_breakdown(ft_exp, ft_batch)
    del ft_exp, ft_batch
    torch.cuda.empty_cache()
    ft["parity"] = finetune_parity(dev)
    lap("finetune")

    # ---- the fine-tune loop of finetune.yml
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = run_finetune_loop(dev, ft["ms_per_step"])
    lap("finetune_loop")

    # ---- the retrieval eval of eval.yml
    torch.cuda.empty_cache()
    ev = run_eval(dev)
    lap("eval")
    print("eval summary: %s" % json.dumps(
        {k: v for k, v in ev.items()
         if k not in ("breakdown", "at_eval_geometry")}))

    # ---- the ResNet-101 chain of finetune_r101 and eval_r101
    torch.cuda.empty_cache()
    r101 = run_r101(dev)
    lap("r101")

    # ---- HED^N-GAN training of train_hedngan.yml
    torch.cuda.empty_cache()
    gan = run_gan_train(dev)
    lap("gan_train")

    # ---- the scenario CLI: hedngan.yml's all and output, cyclegan.yml's
    # train
    torch.cuda.empty_cache()
    scen = run_scenario(dev)
    lap("scenario")

    # ---- HED-GAN, RCF-GAN, RCF^N-GAN and CUT training through the CLI
    torch.cuda.empty_cache()
    fams = run_gan_families(dev)
    lap("gan_families")

    # ---- retrieval search and deployment: build_index, export, the
    # 1,001,001-row exact and PQ indexes, :search, the artifacts' kernels
    torch.cuda.empty_cache()
    srch = run_search(dev)
    lap("search")
    print("search (%d photos + %d distractor rows, %s): %s"
          % (SEARCH_PHOTOS, SEARCH_DB, card, json.dumps(srch)))

    # ---- the training options: HED^N-GAN's knobs, SGD and the rotation,
    # a warm start, the fine-tune's validations with TensorBoard
    torch.cuda.empty_cache()
    opts = run_training_options(dev)
    lap("training_options")

    # ---- every network of the registry no phase above ran: blur-pool CUT
    # and the U-Net CycleGAN trained, the blur-pool generator and the
    # encoder -> decoder served, five descriptor nets' eval, a
    # cirnet_inchan fine-tune step
    torch.cuda.empty_cache()
    arch = run_architectures(dev)
    lap("architectures")

    # ---- the data side: eval and clahepost in luv / lsh / hsv, HED^N-GAN
    # on a deterministic tuple pipeline with the teacher cache, CycleGAN in
    # luv and its image output through reflectpad_divisible
    torch.cuda.empty_cache()
    data = run_data_side(dev)
    lap("data_side")

    # ---- the model side: GlobalLocalModule's local features, the VLAD
    # grouping layers and codebooks, the bf16 multi-head net
    torch.cuda.empty_cache()
    lm = run_local_multihead(dev)
    lap("local_multihead")

    # ---- data parallelism over torch.distributed on the one card, the
    # sharded artifacts, the native decoder
    torch.cuda.empty_cache()
    par = run_parallel(dev)
    lap("parallel")
    by_path = {k: {"serve": desc_launches[k] + gen_launches[k],
                   "finetune": ft["launches"][k],
                   "finetune_loop": loop["launches"][k],
                   "eval": sum(c[k] for c in ev["launches"].values()),
                   "r101": r101["launches"][k],
                   "gan_train": gan["launches"][k],
                   "scenario": scen["launches"][k],
                   "gan_families": fams["launches"][k],
                   "search": srch["launches"][k],
                   "training_options": opts["launches"][k],
                   "architectures": arch["launches"][k],
                   "data_side": data["launches"][k],
                   "local_multihead": lm["launches"][k],
                   "parallel": par["launches"][k]}
               for k in ("K1", "K2", "K3", "K4")}

    print(json.dumps({"kernels": [{
        "name": "clahe_u8 (K1: static CLAHE, LUTs + interpolation in one "
                "kernel)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:62",
        "launches": sum(by_path["K1"].values()),
        "launches_by_path": by_path["K1"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "at_eval_geometry": ev["at_eval_geometry"]["K1"],
        "at_r101_inputs": r101["at_r101_inputs"]["K1"],
    }, {
        "name": "fused_resblock (K3: conv3x3 + IN + ReLU + conv3x3 + IN + x)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/resblock.cu",
        "replaces": "gandtr_tpu/ops/resblock_pallas.py:109",
        "launches": sum(by_path["K3"].values()),
        "launches_by_path": by_path["K3"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }, {
        "name": ("conv3x3_same (K2: VGG16 conv1_2 + conv2_2 of one tuple, "
                 "bias + ReLU, bf16 out)"),
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/vggconv.cu",
        "replaces": "gandtr_tpu/ops/vggconv_pallas.py:94",
        "launches": sum(by_path["K2"].values()),
        "launches_by_path": by_path["K2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": ("clahe_u8_masked (K4: masked CLAHE, LUT build + "
                 "interpolation in one kernel)"),
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:289",
        "launches": sum(by_path["K4"].values()),
        "launches_by_path": by_path["K4"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "at_eval_geometry": ev["at_eval_geometry"]["K4"],
        "at_r101_inputs": r101["at_r101_inputs"]["K4"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
