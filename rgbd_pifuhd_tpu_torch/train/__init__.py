"""Training: optimisers and train steps (``trainers``), the epoch drivers
``train_fine`` / ``pretrain_coarse`` (``loop``)."""
