# Tiny config for integration tests and smoke runs: same schema, keys and
# values as stereoscene_tpu/configs/stereoscene_tiny.py, scaled down to run
# in seconds on the CPU.

_base_ = ['./stereoscene_semantickitti.py']

point_cloud_range = [0, -8.0, -2, 16.0, 8.0, 2.0]
occ_size = [32, 32, 8]

grid_config = {
    'xbound': [0.0, 16.0, 1.0],
    'ybound': [-8.0, 8.0, 1.0],
    'zbound': [-2.0, 2.0, 1.0],
    'dbound': [2.0, 10.0, 0.5],
}

data_config = {
    'input_size': (64, 128),
    'resize': (0.0, 0.0),
    'rot': (0.0, 0.0),
    'flip': False,
    'crop_h': (0.0, 0.0),
    'resize_test': 0.0,
}

model = dict(
    img_backbone=dict(
        arch='b0',
        drop_path_rate=0.0,
        out_indices=(2, 3, 4, 5, 6),
        with_cp=False,
    ),
    img_neck=dict(
        in_channels=[24, 40, 112, 320, 1280],
        upsample_strides=[0.5, 1, 2, 4, 4],
        out_channels=[16, 16, 16, 16, 16],
    ),
    img_view_transformer=dict(
        numC_input=80,
        grid_config=grid_config,
        data_config=data_config,
        numC_Trans=8,
    ),
    img_bev_encoder_backbone=dict(
        block_inplanes=[8, 16, 32],
        norm_cfg=dict(type='GN', num_groups=4, requires_grad=True),
    ),
    img_bev_encoder_neck=dict(
        in_channels=[8, 16, 32],
        out_channels=[8, 8, 8],
        norm_cfg=dict(type='GN', num_groups=4, requires_grad=True),
    ),
    pts_bbox_head=dict(
        in_channels=[24],
        point_cloud_range=point_cloud_range,
    ),
)

data = dict(samples_per_gpu=1, workers_per_gpu=1)
runner = dict(type='EpochBasedRunner', max_epochs=1)
evaluation = dict(interval=100)
