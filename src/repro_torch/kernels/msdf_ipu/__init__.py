"""The PE-array CIPU simulator: kernel B6, its plain version and oracles."""

from .kernel import LAUNCHES, cipu_array, cipu_array_plain
from .ops import simulate_pe_array
from .ref import cipu_array_ref, int_sop_ref
