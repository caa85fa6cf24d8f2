"""Flash attention: kernels B5 (float) and B4 (level-walk scores), their
plain versions, the entry point and the full-matrix oracle."""

from .kernel import (LAUNCHES, flash_attention_kernel,
                     flash_attention_kernel_plain, flash_attention_l2r,
                     flash_attention_l2r_launch, flash_attention_l2r_plain,
                     l2r_byte_split_scores, l2r_kernel_operands,
                     l2r_score_tile)
from .ops import flash_attention
from .ref import attention_ref
