from .ops import (paged_decode_attention, paged_decode_combine,
                  paged_decode_partials, paged_mla_decode_attention,
                  paged_mla_decode_partials, split_plan)
from .ref import (paged_decode_attention_ref, paged_decode_combine_ref,
                  paged_decode_partials_ref, paged_mla_decode_attention_ref,
                  paged_mla_decode_partials_ref)

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_decode_combine", "paged_decode_combine_ref",
           "paged_decode_partials", "paged_decode_partials_ref",
           "paged_mla_decode_attention", "paged_mla_decode_attention_ref",
           "paged_mla_decode_partials", "paged_mla_decode_partials_ref",
           "split_plan"]
