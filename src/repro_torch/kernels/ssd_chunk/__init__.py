from .ops import (SSDScanFn, bwd_plan, ssd_bwd_cb, ssd_bwd_grads,
                  ssd_bwd_states, ssd_chunk_output, ssd_chunk_states,
                  ssd_scan, ssd_scan_bwd, ssd_state_pass)
from .ref import (bwd_groups, ssd_cb_ref, ssd_chunk_grads_ref,
                  ssd_chunk_output_ref, ssd_chunk_states_ref,
                  ssd_dstates_ref, ssd_scan_bwd_phases_ref, ssd_scan_bwd_ref,
                  ssd_scan_ref, ssd_state_pass_bwd_ref, ssd_state_pass_ref)

__all__ = ["SSDScanFn", "bwd_groups", "bwd_plan", "ssd_bwd_cb",
           "ssd_bwd_grads", "ssd_bwd_states", "ssd_cb_ref",
           "ssd_chunk_grads_ref", "ssd_chunk_output", "ssd_chunk_output_ref",
           "ssd_chunk_states", "ssd_chunk_states_ref", "ssd_dstates_ref",
           "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_phases_ref",
           "ssd_scan_bwd_ref", "ssd_scan_ref", "ssd_state_pass",
           "ssd_state_pass_bwd_ref", "ssd_state_pass_ref"]
