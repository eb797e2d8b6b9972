"""clip_ppo_tpu_torch: the PyTorch/CUDA port of clip_ppo_tpu.

Mirrors ``clip_ppo_tpu``'s module paths; imports ``torch`` and never
``jax``. Every kernel the JAX package wrote in Pallas for the TPU gets a
hand-written CUDA kernel here (``csrc/``), built at first use by
:mod:`clip_ppo_tpu_torch.cuda_build`. Entry points run on CUDA unless the
caller asks for the CPU.
"""
