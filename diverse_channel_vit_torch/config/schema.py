"""Config schema defaults (the port's own copy of the JAX package's
``config/schema.py``).

Mirrors the typed dataclass tree of the reference (``config.py:16-275``):
every Optional field's default lives here so group YAMLs only need to state
what they change. Extra research knobs that the reference force-adds via
``++`` on the CLI (e.g. ``gamma_s``, ``hcs_sampling`` — see
``train_scripts.sh`` and ``configs/model/dichavit.yaml``) are first-class
keys here, with the same defaults the reference YAML ships.

The keys and defaults equal the JAX package's, so a composed config equals
the JAX one, with one exception: ``hardware.device`` is ``cuda`` (the JAX
package's is ``tpu``). Keys the port's Trainer does not honour raise there
(``trainer.py``); the comments below say what each key means in JAX.
"""

SECTION_DEFAULTS = {
    "train": {
        "batch_strategy": None,
        "resume_train": False,
        "resume_model": None,
        "use_amp": False,  # interpreted as bf16 compute (no GradScaler needed)
        "checkpoints": "checkpoints",
        "clip_grad_norm": None,
        "batch_size": 64,
        "num_epochs": 40,
        "verbose_batches": 50,
        "seed": None,
        "save_model": "last",
        "debug": False,
        "real_batch_size": None,
        "compile_pytorch": False,  # accepted for CLI parity; everything is jitted anyway
        "adaptive_interface_epochs": 0,
        "adaptive_interface_lr": None,
        "swa": False,
        "swad": False,
        "swa_lr": 0.05,
        "swa_start": 5,
        "miro": False,
        "miro_lr_mult": 10.0,
        "miro_ld": 0.01,
        "tps_prob": 0.0,
        "ssl": False,
        "ssl_lambda": 0.0,
        "training_chunks": None,
        "extra_loss_lambda": 0.0,
        "plot_attn": False,
        # additions of the JAX package
        "dtype": "bfloat16",  # compute dtype inside the model
        "donate_state": True,
        "stratified_chunk_batches": True,  # fixed per-chunk microbatch sizes (static shapes)
        "device_augment": True,  # run JUMP-CP train augmentation on device (ops/augment.py)
        "log_every_n_steps": 50,
        "profile_dir": None,  # a profiler trace of the run (refused by the port)
        "log_memory": False,  # per-epoch device memory live/peak + host RSS telemetry
        # host-RSS watermark recycling: when host RSS exceeds this many GB at
        # an epoch boundary, the JAX trainer saves the preemption checkpoint
        # and re-execs itself (refused by the port). None = off.
        "max_host_rss_gb": None,
        "auto_resume": True,  # resume from a preemption (SIGTERM) checkpoint
        "resume_mid_epoch": True,  # re-enter the interrupted epoch at the exact batch
        "async_checkpoint": False,  # epoch saves commit on a background thread
    },
    "eval": {
        "batch_size": None,
        "dest_dir": "snapshots/results/{FOLDER_NAME}/results",
        "feature_dir": "snapshots/feat_outputs/{FOLDER_NAME}/features",
        "root_dir": "",
        "classifiers": ["knn"],
        "classifier": "",
        "feature_file": "features.npy",
        "use_gpu": True,  # parity key: the kNN matmul runs on the device
        "knn_metrics": ["cosine"],
        "knn_metric": "",
        "meta_csv_file": "",
        "clean_up": True,
        "umap": False,
        "only_eval_first_and_last": False,
        "every_n_epochs": 1,
        "skip_eval_first_epoch": False,
        "skip_eval_for_debug": False,
        "eval_subset_channels": False,
        "channel_combinations": None,
    },
    "model": {
        "name": None,
        "init_weights": True,
        "in_dim": None,
        "num_classes": None,
        "freeze_other": None,
        "separate_norm": None,
        "image_h_w": None,
        "norm_type": None,
        "duplicate": None,
        "pooling_channel_type": None,
        "kernels_per_channel": None,
        "num_templates": None,
        "separate_coef": None,
        "coefs_init": None,
        "freeze_coefs_epochs": None,
        "separate_emb": None,
        "z_dim": None,
        "hidden_dim": None,
        "pretrained": False,
        "pretrained_model_name": None,
        "pooling": "avg",
        "temperature": 0.11111,
        "unfreeze_last_n_layers": -1,
        "init_first_layer": None,
        "unfreeze_first_layer": True,
        "reset_last_n_unfrozen_layers": False,
        "use_auto_rgn": None,
        "unfreeze_vit_layers": None,
        "pretrained_dataset": None,
        "learnable_temp": False,
        "slice_class_emb": False,
        "new_channel_inits": None,
        "enable_sample": False,
        "use_channelvit_channels": True,
        "orthogonal_init": False,
        "use_conv1x1": False,
        "in_channel_names": None,
        "patch_size": 16,
        "z_emb_init": None,
        "freeze_z_emb": False,
        "attn_type": None,
        "is_conv_small": False,
        "z_dim_0": 0,
        "img_size": [224],
        "reduce_size": True,
        "sample_by_weights": False,
        "sample_by_weights_warmup": 0,
        "sample_by_weights_scale": 0.3,
        "generate_first_layer": False,
        "channel_extractor_dim": 64,
        "channel_extractor_patch_size": 0,
        "orth_loss_v1_lambda": 0.0,  # reference schema spells it both ways
        "ortho_loss_v1_lambda": 0.0,
        "proxy_loss_lambda": 0.0,
        "drop_path_rate": 0.0,
        # ChannelViT / DiChaViT knobs (reference force-adds / model YAML keys)
        "orthogonal_channel_emb_init": False,
        "proxy_orthogonal_init": False,
        "freeze_channel_emb": False,
        "dropout_tokens_hcs": "none",
        "keep_rate": None,
        "block_type": "block",
        "hcs_sampling": "none",
        "hcs_sampling_temp": 0.1,
        "gamma_s": 1.0,
        "gamma_d": 0.5,
        "reverse_pos_pairs": False,
        "use_square": False,
        # additions of the JAX package
        # local torch checkpoint path for the ConvNeXt family (zero-egress
        # stand-in for timm's pretrained download; model.pretrained may also
        # be the path string directly)
        "pretrained_ckpt": None,
        # local torchvision-layout resnet34 state dict for the
        # hcs_sampling=*_resnet34 frozen channel scorer (the reference
        # downloads timm's pretrained resnet34; zero-egress stand-in)
        "resnet34_ckpt": None,
        "attention_impl": "auto",  # auto | pallas | xla
        "remat": False,  # rematerialize transformer blocks (HBM headroom)
        "scan_blocks": False,  # one nn.scan loop over blocks (fast compile; stacked params)
        "gelu_exact": False,  # True = torch nn.GELU (erf) bit-parity; ~1.8ms/layer slower
        "fused_block": True,  # the fused attend_project + ln_mlp kernels (bf16)
        "quantization": "none",  # "int8": in-VMEM AQT GEMMs in the fused MLP (opt-in)
        "cls_only_readout": True,  # last block: queries+MLP on the CLS row only (exact; auto-gated off under capture/dropout/ring — models/vit.py:cls_readout_ok)
        # size-preset overrides; num_heads=3 at ViT-S width = head_dim 128,
        # the MXU-native geometry (+42% throughput, same params/FLOPs)
        "embed_dim": None,
        "depth": None,
        "num_heads": None,
    },
    "dataset": {
        "name": None,
        "img_size": 224,
        "label_column": None,
        "root_dir": "",
        "file_name": "",
        "in_channel_names": None,
    },
    "data_chunk": {
        "chunks": [],
    },
    "optimizer": {
        "name": "adamw",
        "params": {},
    },
    "scheduler": {
        "name": "none",
        "convert_to_batch": False,
        "params": {},
    },
    "logging": {
        "wandb": {
            "use_wandb": False,
            "log_freq": 10000,
            "num_images_to_log": 0,
            "log_imgs_every_n_epochs": 0,
            "project_name": None,
            "run_name": None,
        },
        "use_py_log": False,
        "scc_jobid": None,
        # beyond reference: TensorBoard scalar sink
        "tensorboard": False,
        "tensorboard_dir": "tb_logs",
    },
    "hardware": {
        "num_workers": 3,
        # True: train loaders use SPAWNED worker processes (true parallelism
        # for GIL-bound numpy augmentation, e.g. TPS); False: thread pool
        "worker_processes": False,
        "device": "cuda",  # the JAX package's is "tpu"
        "multi_gpus": None,  # parity key: None/ddp/DataParallel all map to mesh data-parallel
        "num_gpus": 1,
        # device mesh axes: -1 means "all remaining devices" (one card in the
        # port; an axis of more than one device raises, ROADMAP A10)
        "mesh": {"data": -1, "model": 1},
        # ZeRO-1 / ZeRO-3 optimizer-state and parameter sharding over the data
        # axis (refused by the port, ROADMAP A10)
        "zero1": False,
        "zero3": False,
    },
    "attn_pooling": {
        "max_num_channels": None,
        "dim": None,
        "depth": 1,
        "dim_head": 16,
        "heads": 4,
        "mlp_dim": 4,
        "dropout": 0.0,
        "use_cls_token": False,
        "use_channel_tokens": False,
        "init_channel_tokens": None,
    },
}
