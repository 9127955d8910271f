"""Run-time helpers of the training loop: the step timer, the json_stats
log lines and the PROF_DAG trace (ports of ``lfb_tpu/utils/``)."""
