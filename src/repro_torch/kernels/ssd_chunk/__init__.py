from .ops import ssd_chunk_output, ssd_chunk_states, ssd_scan, ssd_state_pass
from .ref import (ssd_chunk_output_ref, ssd_chunk_states_ref, ssd_scan_ref,
                  ssd_state_pass_ref)

__all__ = ["ssd_chunk_output", "ssd_chunk_output_ref", "ssd_chunk_states",
           "ssd_chunk_states_ref", "ssd_scan", "ssd_scan_ref",
           "ssd_state_pass", "ssd_state_pass_ref"]
