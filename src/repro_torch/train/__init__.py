from repro_torch.train.step import TrainConfig, TrainState, make_train_step
