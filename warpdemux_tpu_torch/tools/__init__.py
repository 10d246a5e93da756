"""The tools of the port: the trainers of the boundary CNN (train_cnn) and
the stand-in tRNA model (train_trna_model), and the live lane's latency
and soak measurements (live_latency, live_soak)."""
