"""Measurement tools of the port (ports of the repo's tools/ scripts):
profile_host, weak_scaling, dp_eval_bench and vocab_recall, each run as
`python -m spslam_tpu_torch.tools.<name>`."""
