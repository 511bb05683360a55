"""backward_ms_per_step.train: the median, over the window's training steps,
of the device-stream ms of the step's backward (`train.backward`: autograd
around the renderer, K1's backward kernels and cuBLAS, summed over its
sub-batches): `forward_ms_per_step.train`'s reader on that span."""

import functools
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "forward_ms_per_step_train", Path(__file__).with_name("forward_ms_per_step.train.py"))
_forward = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_forward)

read = functools.partial(_forward.read, phase="train.backward")
