"""Host C++ components, built with g++ at first use (`native/build.py`):
the MAS recurrence (`mas_native`) and the batch WAV reader that the training
data pipeline uses (`wavio_native`)."""

from matcha_tts_tpu_torch.native import mas_native, wavio_native


def native_available() -> bool:
    """Whether both native libraries build and load on this host."""
    return mas_native.native_available() and wavio_native.native_available()
