# StereoScene on SemanticKITTI — active config of the PyTorch port.
#
# The same keys and values as stereoscene_tpu/configs/stereoscene_semantickitti.py,
# which mirror the reference config surface
# (projects/configs/occupancy/semantickitti/stereoscene.py) so users of the
# reference can bring their configs over unchanged. The `tpu` dict holds the
# JAX package's runtime options; it is kept so both packages load the same
# dict, and the port reads none of it.

camera_used = ['left', 'right']

class_names = [
    'unlabeled', 'car', 'bicycle', 'motorcycle', 'truck', 'other-vehicle',
    'person', 'bicyclist', 'motorcyclist', 'road', 'parking', 'sidewalk',
    'other-ground', 'building', 'fence', 'vegetation', 'trunk', 'terrain',
    'pole', 'traffic-sign'
]

point_cloud_range = [0, -25.6, -2, 51.2, 25.6, 4.4]
occ_size = [256, 256, 32]
lss_downsample = [2, 2, 2]

voxel_x = (point_cloud_range[3] - point_cloud_range[0]) / occ_size[0]
voxel_y = (point_cloud_range[4] - point_cloud_range[1]) / occ_size[1]
voxel_z = (point_cloud_range[5] - point_cloud_range[2]) / occ_size[2]

img_norm_cfg = dict(
    mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True)

data_config = {
    'input_size': (384, 1280),
    'resize': (0.0, 0.0),
    'rot': (0.0, 0.0),
    'flip': False,
    'crop_h': (0.0, 0.0),
    'resize_test': 0.0,
}

grid_config = {
    'xbound': [point_cloud_range[0], point_cloud_range[3], voxel_x * lss_downsample[0]],
    'ybound': [point_cloud_range[1], point_cloud_range[4], voxel_y * lss_downsample[1]],
    'zbound': [point_cloud_range[2], point_cloud_range[5], voxel_z * lss_downsample[2]],
    'dbound': [2.0, 58.0, 0.5],
}

numC_Trans = 128
voxel_channels = [128, 256, 512]
voxel_out_indices = (0, 1, 2)
voxel_out_channels = [128, 128, 128]
norm_cfg = dict(type='GN', num_groups=32, requires_grad=True)

model = dict(
    type='BEVDepthOccupancy',
    img_backbone=dict(
        type='CustomEfficientNet',
        arch='b7',
        drop_path_rate=0.2,
        frozen_stages=0,
        norm_eval=False,
        out_indices=(2, 3, 4, 5, 6),
        with_cp=True,
        pretrained='pretrain/efficientnet-b7.ckpt',
    ),
    img_neck=dict(
        type='SECONDFPN',
        in_channels=[48, 80, 224, 640, 2560],
        upsample_strides=[0.5, 1, 2, 4, 4],
        out_channels=[128, 128, 128, 128, 128],
    ),
    img_view_transformer=dict(
        type='ViewTransformerLiftSplatShootVoxel',
        downsample=8,
        numC_input=640,
        cam_channels=30,
        loss_depth_weight=1.0,
        loss_depth_type='bce',
        grid_config=grid_config,
        data_config=data_config,
        numC_Trans=numC_Trans,
    ),
    img_bev_encoder_backbone=dict(
        type='CustomResNet3D',
        depth=18,
        num_stage=3,
        n_input_channels=numC_Trans,
        block_inplanes=voxel_channels,
        out_indices=voxel_out_indices,
        norm_cfg=norm_cfg,
    ),
    img_bev_encoder_neck=dict(
        type='SECONDFPN3D',
        norm_cfg=norm_cfg,
        in_channels=voxel_channels,
        upsample_strides=[1, 2, 4],
        out_channels=voxel_out_channels,
    ),
    pts_bbox_head=dict(
        type='OccHead',
        num_level=1,
        in_channels=[sum(voxel_out_channels)],
        out_channel=20,
        semantic_kitti=True,
        point_cloud_range=point_cloud_range,
        supervise_points=False,
        sampling_img_feats=True,
        in_img_channels=640,
        soft_weights=True,
        semkitti_loss_weight_cfg={
            'voxel_ce': 1.0,
            'voxel_sem_scal': 1.0,
            'voxel_geo_scal': 1.0,
            'voxel_ohem': 0.0,
            'voxel_lovasz': 0.0,
            'frustum_dist': 0.0,
        },
    ),
)

dataset_type = 'CustomSemanticKITTILssDataset'
data_root = './data/occupancy/semanticKITTI/RGB/'
ann_file = './data/occupancy/semanticKITTI/lss-semantic_kitti_voxel_label/labels/'
lidar_root = './data/lidar/velodyne/dataset/sequences'
lidarseg_root = './data/lidar/lidarseg/dataset/sequences'

bda_aug_conf = dict(
    rot_lim=(-22.5, 22.5),
    scale_lim=(0.95, 1.05),
    flip_dx_ratio=0.5,
    flip_dy_ratio=0.5)

data = dict(
    samples_per_gpu=2,
    workers_per_gpu=8,
    train=dict(
        type=dataset_type,
        data_root=data_root,
        ann_file=ann_file,
        classes=class_names,
        occ_size=occ_size,
        pc_range=point_cloud_range,
        split='train',
        camera_used=camera_used,
        test_mode=False,
    ),
    val=dict(
        type=dataset_type,
        data_root=data_root,
        ann_file=ann_file,
        classes=class_names,
        occ_size=occ_size,
        pc_range=point_cloud_range,
        split='val',
        camera_used=camera_used,
        test_mode=True,
    ),
    test=dict(
        type=dataset_type,
        data_root=data_root,
        ann_file=ann_file,
        classes=class_names,
        occ_size=occ_size,
        pc_range=point_cloud_range,
        split='test',
        camera_used=camera_used,
        test_mode=True,
    ),
)

optimizer = dict(type='AdamW', lr=1e-4, weight_decay=0.01)
optimizer_config = dict(grad_clip=dict(max_norm=5, norm_type=2))
lr_config = dict(policy='step', step=[20, 25])
checkpoint_config = dict(max_keep_ckpts=2, interval=1)
runner = dict(type='EpochBasedRunner', max_epochs=30)
evaluation = dict(interval=2, save_best='semkitti_combined_IoU', rule='greater')

# the JAX package's runtime options (no reference equivalent; unread here)
tpu = dict(
    compute_dtype='bfloat16',
    mesh_axes=('data',),
    remat_backbone=True,
    attention_chunk=1024,
)
