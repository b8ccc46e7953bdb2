"""Typed kernel-launch errors and the CUDA status names behind them.

Every C entry of ``csrc/`` returns a ``cudaError_t`` (0 on success).  A
wrapper that gets a non-zero status raises `KernelLaunchError`, which
carries the code and its name, so a caller (the scheduler's error
classifier) tells a refused argument from a lost device without parsing
the message.
"""

from __future__ import annotations

#: ``cudaError_t`` codes the package names: ``code -> (enum name,
#: cudaGetErrorString text)``, as CUDA 12's runtime headers define them.
CUDA_ERRORS: dict[int, tuple[str, str]] = {
    1: ("cudaErrorInvalidValue", "invalid argument"),
    2: ("cudaErrorMemoryAllocation", "out of memory"),
    3: ("cudaErrorInitializationError", "initialization error"),
    9: ("cudaErrorInvalidConfiguration", "invalid configuration argument"),
    46: ("cudaErrorDevicesUnavailable", "CUDA-capable device(s) is/are busy or unavailable"),
    98: ("cudaErrorInvalidDeviceFunction", "invalid device function"),
    100: ("cudaErrorNoDevice", "no CUDA-capable device is detected"),
    101: ("cudaErrorInvalidDevice", "invalid device ordinal"),
    209: ("cudaErrorNoKernelImageForDevice",
          "no kernel image is available for execution on the device"),
    214: ("cudaErrorECCUncorrectable", "uncorrectable ECC error encountered"),
    220: ("cudaErrorNvlinkUncorrectable",
          "uncorrectable NVLink error detected during the execution"),
    700: ("cudaErrorIllegalAddress", "an illegal memory access was encountered"),
    701: ("cudaErrorLaunchOutOfResources", "too many resources requested for launch"),
    702: ("cudaErrorLaunchTimeout", "the launch timed out and was terminated"),
    710: ("cudaErrorAssert", "device-side assert triggered"),
    716: ("cudaErrorMisalignedAddress", "misaligned address"),
    719: ("cudaErrorLaunchFailure", "unspecified launch failure"),
    802: ("cudaErrorSystemNotReady", "system not yet initialized"),
    999: ("cudaErrorUnknown", "unknown error"),
}

_BY_TEXT = {text: name for name, text in CUDA_ERRORS.values()}


def cuda_error_name(code: int) -> str:
    """The enum name of a ``cudaError_t`` code (``cudaError<code>`` when the
    table does not list it)."""
    entry = CUDA_ERRORS.get(int(code))
    return entry[0] if entry else f"cudaError{int(code)}"


def cuda_error_name_of_text(text: str) -> str | None:
    """The enum name of a ``cudaGetErrorString`` text, or None."""
    return _BY_TEXT.get(text.strip())


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a non-zero ``cudaError_t``: ``.code`` and
    its enum ``.name`` (``cudaErrorInvalidValue`` where the entry refused
    the shape it was given)."""

    def __init__(self, kernel: str, code: int):
        super().__init__(f"{kernel} kernel launch failed: CUDA error {int(code)}")
        self.code = int(code)
        self.name = cuda_error_name(code)
