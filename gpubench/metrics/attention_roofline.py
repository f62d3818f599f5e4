"""The least time of the traced volumes' flash attention (V3: 4 N^2 E
operations a block and window at 989 TFLOP/s, or its q, k, v and output
bytes at 3.35 TB/s, the larger) over the device seconds of V3's records
(`flash_attention_kernel`) among the traced stretch's top device
operations (%). The least time a volume comes from the driver, under its
span `v3_least_s`. Read as `attention_roofline.vit`."""

KERNEL = "flash_attention_kernel"


def read(rec) -> float | None:
    t = rec.trace
    least = rec.spans_s.get("v3_least_s")
    if t is None or not least:
        return None
    busy = sum(s for name, s in t.device_ops if KERNEL in name)
    if busy <= 0:
        return None
    return 100.0 * least[0] * t.requests / busy
