"""The process layer (`k8s_scheduler_tpu/cmd/`): the health, metrics and
debug HTTP server and the file-lease leader election."""
