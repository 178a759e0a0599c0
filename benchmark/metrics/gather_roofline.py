"""The gather's (``csrc/permute.cu``) share of its byte bound over the
traced segment: each launch moves every word of every row once each way
and reads the permutation (``counts.gather_bytes``), in percent."""
import counts


def read(rec):
    fam = rec["families"]
    times = [(e - s) / 1e9 for name, s, e in rec["kernels"]
             if fam(name) == "gather"]
    if not times:
        return None
    n_bytes = counts.gather_bytes(rec["gather_words"], rec["work"]["n"])
    return 100.0 * len(times) * n_bytes / counts.HBM_BYTES_PER_S / sum(times)
