"""``attn_roofline``: the attention calls' share (%) of their roofline,
sum of bounds / sum of device times over every call of the profiled clip
(the one after the measured window).

A call is one ``dot_product_attention`` as the model modules call it,
inside the span the benchmark opens around it (``bench/port.py``), which
records B, H, Sq, Sk, D and the dtype. Its device time is every kernel
launched under the span. Its bound is the larger of 4*B*H*Sq*Sk*D FLOPs
(Sk counting only the keys a kv mask keeps) at the tensor-core peak of the
inputs' dtype, and the bytes of q, k, v and o, each read or written once,
at 3.35 TB/s. The peaks are the card's own (H100 SXM data sheet): bf16 and
fp16 989 TFLOP/s, fp32 495 TFLOP/s (TF32), so no implementation can read
over 100%. Nothing when no call ran a kernel.
"""

PEAK = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
HBM = 3.35e12


def bound_s(B: int, H: int, Sq: int, Sk: int, D: int, dtype: str, kept=None) -> float:
    """``kept``: the keys a kv mask keeps, summed over the batch."""
    ops = 4.0 * H * Sq * D * (B * Sk if kept is None else kept)
    nbytes = BYTES[dtype] * B * H * D * (2 * Sq + 2 * Sk)
    return max(ops / PEAK[dtype], nbytes / HBM)


def parse(tag: str, kept: dict):
    """'BxHxSqxSkxD:dtype[:m<id>]' -> (B, H, Sq, Sk, D, dtype, kept keys)."""
    parts = tag.split(":")
    B, H, Sq, Sk, D = (int(x) for x in parts[0].split("x"))
    mask = kept[int(parts[2][1:])] if len(parts) > 2 else None
    return B, H, Sq, Sk, D, parts[1], mask


def read(record: dict):
    tr = record["trace"]
    if not tr or not tr["attn"]:
        return None
    bound = busy = 0.0
    for tag, device_s in tr["attn"]:
        if device_s <= 0:
            continue
        bound += bound_s(*parse(tag, record.get("attn_kept", {})))
        busy += device_s
    return 100.0 * bound / busy if busy > 0 else None
