"""The coordinatewise selection (median, trimmed_mean;
``ops/csrc/select_columns.cu``): the bytes one call has to move, each once:
the [K, d] f32 stack and, with the channel folded into the read, its
[K, d] noise arrays n_r and n_i and its [K] terms h_r, h_i and |h|^2; the
[d] result written."""

WRAPPER = "select_columns"
#: one select_kernel per launch; the global plan adds a keys_kernel
COUNTED = ("select_kernel",)
TIMED = ("select_kernel", "keys_kernel")


def call_bytes(k: int, d: int, channel: bool) -> int:
    return 4 * (k * d + (2 * k * d + 3 * k if channel else 0) + d)
