"""transductive_clip_tpu_torch — the PyTorch/CUDA port of transductive_clip_tpu.

It runs on one NVIDIA Hopper card (``cuda:{cfg.device}``); the CPU is used
only when a caller asks for it with ``device="cpu"``. The JAX package beside
it is the reference each ported function is tested against. The port keeps
the JAX package's module layout, so each module here has its counterpart at
the same relative path there, and imports nothing from it.

Ported so far: zero-shot EM-Dirichlet (soft and hard) and few-shot
alpha-TIM, TIM-GD and EM-Dirichlet, from the CLI down to the TSV row, with
the two Dirichlet row-solve kernels and the alpha-TIM support-gradient
kernel written in CUDA C++ for sm_90a (``csrc/``). ROADMAP.md lists what is
still to port.
"""

__version__ = "0.1.0"
