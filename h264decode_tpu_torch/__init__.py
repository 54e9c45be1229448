"""H.264/AVC decoder on PyTorch and CUDA: the GPU port of h264decode_tpu.

Entry points: pipeline.gpu_pipeline.GpuDecoder, and
`python -m h264decode_tpu_torch decode|probe`.
"""
