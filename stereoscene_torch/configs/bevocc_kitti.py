# BEVOcc_kitti: camera-only BEVFormer-style occupancy (the reference's
# BEVOcc subsystem, detectors/bevocc_kitti.py +
# dense_heads/bevocc_head_kitti.py); the same keys and values as
# stereoscene_tpu/configs/bevocc_kitti.py. The head keys mirror the
# reference's BEVOccHead arguments; read by models.bevocc.bevocc_from_config.

point_cloud_range = [0, -25.6, -2, 51.2, 25.6, 4.4]
occ_size = [128, 128, 16]

model = dict(
    type='BEVOcc_kitti',
    use_grid_mask=False,
    img_backbone=dict(
        type='CustomEfficientNet',
        arch='b0',
        out_indices=(5,),
    ),
    img_neck_out_channels=64,
    pts_bbox_head=dict(
        type='BEVOccHead',
        # coarsest level; finest = bev * 2^(fpn_level-1) = 128x128x16,
        # matching occ_size (bevocc_loss wants gt at the finest scale)
        bev_h=64,
        bev_w=64,
        bev_z=8,
        fpn_level=2,
        embed_dims=128,
        out_channel=20,
        use_semantic=True,
        pred_ground=False,
        encoder_layers=2,
        norm_groups=8,
        point_cloud_range=point_cloud_range,
    ),
)
