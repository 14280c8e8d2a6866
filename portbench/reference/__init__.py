"""Plain PyTorch reference of the configurations the benchmark runs.

Frozen copies of the published equations, written from the papers and the
upstream repositories' layer definitions: the text frontend (`text.py`),
Matcha-TTS's encoder, duration predictor, U-Net and Euler CFM (`matcha.py`),
HiFi-GAN V1 (`hifigan.py`), Vocos (`vocos.py`), and the STFT, denoiser and
PCM16 packing (`dsp.py`).  Parameters are a dict of tensors keyed by the
names `portbench/lib/weights.py` draws, which are the port's `state_dict`
names, in the layouts PyTorch's layers use.

Nothing here imports the port, JAX or the JAX package.  Every product runs
through a `Prec` (`prec.py`): float32 with TF32 off for the reference, a
lower precision for the control that `correct` has to reject.
"""
