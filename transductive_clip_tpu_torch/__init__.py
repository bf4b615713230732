"""transductive_clip_tpu_torch — the PyTorch/CUDA port of transductive_clip_tpu.

It runs on one NVIDIA Hopper card (``cuda:{cfg.device}``); the CPU is used
only when a caller asks for it with ``device="cpu"``. The JAX package beside
it is the reference each ported function is tested against. The port keeps
the JAX package's module layout, so each module here has its counterpart at
the same relative path there, and imports nothing from it.

Ported so far: every transductive method of the JAX package (zero-shot
EM-Dirichlet soft and hard, soft, hard and KL k-means, EM-Gaussian with and
without a diagonal precision, inductive CLIP; few-shot EM-Dirichlet soft
and hard, alpha-TIM, TIM-GD, PADDLE, BD-CSPN, LaplacianShot) on softmax or
visual features, from the CLI down to the TSV row, and
CLIP feature extraction (the nine OpenAI towers, images to feature cache),
with the two Dirichlet row-solve kernels, the alpha-TIM support-gradient
kernel, the two attention kernels and the fused ResNet bottleneck written
in CUDA C++ for sm_90a (``csrc/``); the evaluators' deferred and fused
pipelines, and the cluster->class matching on the host (the C++ LAP solver
of ``native/``) or on the card (the batched auction, ``csrc/auction.cu``).
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
