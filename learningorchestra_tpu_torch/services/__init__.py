"""The REST services of the port, same surface as the reference's.

| port | service           | routes                                   |
|------|-------------------|------------------------------------------|
| 5000 | database_api      | POST/GET /files, GET/DELETE /files/<f>   |
| 5001 | projection        | POST /projections/<parent>               |
| 5002 | model_builder     | POST /models, /models/sweep, predict     |
| 5003 | data_type_handler | PATCH /fieldtypes/<f>                    |
| 5004 | histogram         | POST /histograms/<parent>                |
| 5005 | tsne              | POST/GET/DELETE /images[...]             |
| 5006 | pca               | POST/GET/DELETE /images[...]             |
| 5007 | router            | POST /models/<name>/predict, GET /models/<name> |

Each module exposes ``create_app(store, ...) -> WebApp``;
``services.runner`` serves all seven in one process over one store. The
fleet router (``serve/router.py``) runs only as its own process
(``LO_SERVICE=router``): in front of no replicas it routes nothing.
"""

DATABASE_API_PORT = 5000
PROJECTION_PORT = 5001
MODEL_BUILDER_PORT = 5002
DATA_TYPE_HANDLER_PORT = 5003
HISTOGRAM_PORT = 5004
TSNE_PORT = 5005
PCA_PORT = 5006
ROUTER_PORT = 5007
