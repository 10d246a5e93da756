"""The trainers of the port: the boundary CNN (train_cnn) and the stand-in
tRNA model (train_trna_model)."""
