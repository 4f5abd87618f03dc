# High-resolution config of the PyTorch port: the same keys and values as
# stereoscene_tpu/configs/stereoscene_highres.py. A full-resolution LSS
# grid of 256x256x32 voxels with 512x512x64 supervision; the grid's X axis
# may be sharded over a group of ranks (tools/train.py --spatial-shards N,
# stereoscene_torch/parallel/spatial.py), which exchanges the convolution
# halos by hand.

_base_ = ['./stereoscene_semantickitti.py']

point_cloud_range = [0, -25.6, -2, 51.2, 25.6, 4.4]
occ_size = [512, 512, 64]
lss_downsample = [2, 2, 2]  # LSS grid = 256x256x32

voxel_x = (point_cloud_range[3] - point_cloud_range[0]) / occ_size[0]
voxel_y = (point_cloud_range[4] - point_cloud_range[1]) / occ_size[1]
voxel_z = (point_cloud_range[5] - point_cloud_range[2]) / occ_size[2]

grid_config = {
    'xbound': [point_cloud_range[0], point_cloud_range[3], voxel_x * lss_downsample[0]],
    'ybound': [point_cloud_range[1], point_cloud_range[4], voxel_y * lss_downsample[1]],
    'zbound': [point_cloud_range[2], point_cloud_range[5], voxel_z * lss_downsample[2]],
    'dbound': [2.0, 58.0, 0.5],
}

model = dict(
    img_view_transformer=dict(grid_config=grid_config),
    # stream the ce/sem_scal/geo_scal evaluation over 16 Y-slabs: the
    # 2x-upsampled fp32 loss tensors are never built whole
    pts_bbox_head=dict(
        semkitti_loss_weight_cfg=dict(stream_voxel_chunks=16),
    ),
)

# the JAX package's runtime options (no reference equivalent; unread here)
tpu = dict(
    compute_dtype='bfloat16',
    mesh_axes=('data', 'space'),
    remat_backbone=True,
    attention_chunk=1024,
)
