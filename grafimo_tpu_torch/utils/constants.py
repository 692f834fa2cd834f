"""Framework-wide constants.

The numeric constants must match the reference implementation exactly for
hit/p-value parity (reference: ``src/grafimo/utils.py:19-32``).
"""

import numpy as np

# DNA alphabet, fixed row order of every PWM tensor (reference utils.py:19)
DNA_ALPHABET = ["A", "C", "G", "T"]
# base -> integer code used by the packed window tensors (A=0 C=1 G=2 T=3)
NUC2CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
CODE2NUC = "ACGT"
# code used for any non-ACGT symbol in packed tensors (scored as min_score,
# reference score_sequences.py:376-378)
N_CODE = 4
# code used for batch-padding rows: scored -1 and excluded from histograms
PAD_CODE = 5

REV_COMPL = {"A": "T", "C": "G", "G": "C", "T": "A"}

# background pseudo-probability added before normalisation
# (reference utils.py:24)
PSEUDOBG = np.double(0.0000005)
# log2 computed as ln(x) * LOG_FACTOR, C-style (reference utils.py:25,479-495)
LOG_FACTOR = 1.44269504
# integer scaling range of the log-odds matrix (reference utils.py:26)
RANGE = 1000

# sentinel values (reference utils.py:21-23,28)
NOMAP = "NOMAP"
ALL_CHROMS = "use_all_chroms"
UNIF = "unfrm_dst"
DEFAULT_OUTDIR = "default_out_dir_name"

CHROMS_LIST = [str(i) for i in range(1, 23)] + ["X", "Y"]

# GFF3 fixed fields (reference utils.py:30-32)
SOURCE = "grafimo"
TP = "nucleotide_motif"
PHASE = "."
