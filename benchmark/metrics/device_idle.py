"""Share of the unprofiled wall of the traced segment in which no operation
ran on the device: 1 - busy / wall (``tools/profile_torch_step.py``'s
method), in percent."""


def read(rec):
    if rec["wall_s"] <= 0 or not rec["kernels"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["wall_s"])
